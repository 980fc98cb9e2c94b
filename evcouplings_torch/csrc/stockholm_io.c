/*
 * Single-pass Stockholm reader with a plain C interface (loaded through
 * ctypes by evcouplings_torch/native/__init__.py).
 *
 *   int evc_parse_stockholm(const char *path, EvcParse *out);
 *
 * Stockholm is what jackhmmer and hmmsearch write; large results
 * interleave the sequences across blocks (an id comes back once per
 * block, and its residue chunks are concatenated). This pass does that
 * concatenation in C:
 *
 * - ids in first-appearance order, the (N, L) residue block as one
 *   contiguous buffer;
 * - the raw "#..." markup lines (right-stripped), for the Python wrapper
 *   to assemble into the GF/GC/GS/GR annotation: markup is small next to
 *   the residues, whose concatenation is the hot loop;
 * - only the first alignment of the file (from_file's semantics): the
 *   pass stops at the "//" terminator.
 *
 * A ValueError status for a missing "# STOCKHOLM 1.0" header, a missing
 * "//" terminator (truncated file), ragged rows, no sequences, or input
 * the strict guard refuses (io_common.h). Callers fall back to the
 * Python reader on ValueError.
 */

#include "io_common.h"

/* open-addressing string hash map: id -> sequence slot */

typedef struct {
    const char *key;
    long long keylen;
    long long slot;
} HashEntry;

typedef struct {
    HashEntry *entries;
    size_t capacity;   /* power of two */
    size_t size;
} HashMap;

static uint64_t
hash_bytes(const char *s, long long n)
{
    uint64_t h = 1469598103934665603ULL;   /* FNV-1a */
    for (long long i = 0; i < n; i++) {
        h ^= (unsigned char)s[i];
        h *= 1099511628211ULL;
    }
    return h;
}

static int
map_init(HashMap *m, size_t capacity)
{
    m->capacity = capacity;
    m->size = 0;
    m->entries = (HashEntry *)calloc(capacity, sizeof(HashEntry));
    return m->entries != NULL;
}

static int
map_grow(HashMap *m)
{
    size_t new_cap = m->capacity * 2;
    HashEntry *ne = (HashEntry *)calloc(new_cap, sizeof(HashEntry));
    if (ne == NULL) {
        return 0;
    }
    for (size_t i = 0; i < m->capacity; i++) {
        HashEntry *e = &m->entries[i];
        if (e->key == NULL) {
            continue;
        }
        size_t j = hash_bytes(e->key, e->keylen) & (new_cap - 1);
        while (ne[j].key != NULL) {
            j = (j + 1) & (new_cap - 1);
        }
        ne[j] = *e;
    }
    free(m->entries);
    m->entries = ne;
    m->capacity = new_cap;
    return 1;
}

/* the slot of key; a new key gets next_slot (and *is_new is set); -1 on
 * allocation failure */
static long long
map_get_or_add(HashMap *m, const char *key, long long keylen,
               long long next_slot, int *is_new)
{
    if (m->size * 2 >= m->capacity && !map_grow(m)) {
        return -1;
    }
    size_t j = hash_bytes(key, keylen) & (m->capacity - 1);
    while (m->entries[j].key != NULL) {
        HashEntry *e = &m->entries[j];
        if (e->keylen == keylen && memcmp(e->key, key, (size_t)keylen) == 0) {
            *is_new = 0;
            return e->slot;
        }
        j = (j + 1) & (m->capacity - 1);
    }
    m->entries[j].key = key;
    m->entries[j].keylen = keylen;
    m->entries[j].slot = next_slot;
    m->size++;
    *is_new = 1;
    return next_slot;
}

typedef struct {
    const char *id;
    long long idlen;
    char *seq;          /* growable residue buffer */
    long long len;
    long long cap;
} SeqSlot;

static const char STOCKHOLM_HEADER[] = "# STOCKHOLM 1.0";

int
evc_parse_stockholm(const char *path, EvcParse *out)
{
    memset(out, 0, sizeof(*out));

    long long fsize = 0;
    char *buf = evc_slurp_file(path, &fsize, out);
    if (buf == NULL) {
        return out->status;
    }
    if (!evc_ascii_clean(buf, (size_t)fsize, out)) {
        free(buf);
        return out->status;
    }

    SeqSlot *slots = NULL;
    long long n_slots = 0, cap_slots = 0;
    HashMap map;
    EvcBuf markup = {NULL, 0, 0}, ids = {NULL, 0, 0};
    long long n_markup = 0;
    char *seqs = NULL;
    int saw_terminator = 0;

    if (!map_init(&map, 1024)) {
        free(buf);
        return evc_fail(out, EVC_NO_MEMORY, 0, "reading %s", path);
    }

    char *p = buf;
    char *end = buf + fsize;
    int first_line = 1;
    while (p < end) {
        char *eol = memchr(p, '\n', (size_t)(end - p));
        char *line_end = eol ? eol : end;
        /* rstrip */
        while (line_end > p && (line_end[-1] == '\r' || line_end[-1] == ' '
                                || line_end[-1] == '\t')) {
            line_end--;
        }
        long long linelen = line_end - p;

        if (first_line) {
            if (linelen < (long long)(sizeof(STOCKHOLM_HEADER) - 1)
                    || memcmp(p, STOCKHOLM_HEADER,
                              sizeof(STOCKHOLM_HEADER) - 1) != 0) {
                evc_fail(out, EVC_VALUE_ERROR, 0,
                         "Not a valid Stockholm alignment: Header missing.");
                goto done;
            }
            first_line = 0;
        } else if (linelen >= 2 && p[0] == '/' && p[1] == '/') {
            saw_terminator = 1;
            break;
        } else if (linelen > 0 && p[0] == '#') {
            if (!evc_buf_record(&markup, p, (size_t)linelen)) {
                evc_fail(out, EVC_NO_MEMORY, 0, "reading %s", path);
                goto done;
            }
            n_markup++;
        } else if (linelen > 0) {
            /* "id  residues", split as Python's str.split() splits, which
             * also skips LEADING whitespace */
            char *id_start = p;
            while (id_start < line_end
                   && (*id_start == ' ' || *id_start == '\t')) {
                id_start++;
            }
            char *sp = id_start;
            while (sp < line_end && *sp != ' ' && *sp != '\t') {
                sp++;
            }
            char *res = sp;
            while (res < line_end && (*res == ' ' || *res == '\t')) {
                res++;
            }
            if (sp == id_start || res == line_end) {
                /* no id/residues split: ignored, as the Python reader
                 * ignores it (len(splitted) != 2) */
                goto next_line;
            }
            /* whitespace inside the residue field would give the Python
             * reader's split three fields: ignored */
            for (char *q = res; q < line_end; q++) {
                if (*q == ' ' || *q == '\t') {
                    goto next_line;
                }
            }

            int is_new = 0;
            long long slot = map_get_or_add(&map, id_start, sp - id_start,
                                            n_slots, &is_new);
            if (slot < 0) {
                evc_fail(out, EVC_NO_MEMORY, 0, "reading %s", path);
                goto done;
            }
            if (is_new) {
                if (n_slots == cap_slots) {
                    long long nc = cap_slots ? cap_slots * 2 : 1024;
                    SeqSlot *ns = (SeqSlot *)realloc(
                        slots, (size_t)nc * sizeof(SeqSlot));
                    if (ns == NULL) {
                        evc_fail(out, EVC_NO_MEMORY, 0, "reading %s", path);
                        goto done;
                    }
                    slots = ns;
                    cap_slots = nc;
                }
                slots[n_slots].id = id_start;
                slots[n_slots].idlen = sp - id_start;
                slots[n_slots].seq = NULL;
                slots[n_slots].len = 0;
                slots[n_slots].cap = 0;
                n_slots++;
            }

            SeqSlot *s = &slots[slot];
            long long chunk = line_end - res;
            if (s->len + chunk > s->cap) {
                long long nc = s->cap ? s->cap * 2 : chunk * 2;
                if (nc < s->len + chunk) {
                    nc = s->len + chunk;
                }
                char *nb = (char *)realloc(s->seq, (size_t)nc);
                if (nb == NULL) {
                    evc_fail(out, EVC_NO_MEMORY, 0, "reading %s", path);
                    goto done;
                }
                s->seq = nb;
                s->cap = nc;
            }
            memcpy(s->seq + s->len, res, (size_t)chunk);
            s->len += chunk;
        }

    next_line:
        p = eol ? eol + 1 : end;
    }

    if (!saw_terminator) {
        /* a truncated alignment: the Python reader yields nothing */
        evc_fail(out, EVC_VALUE_ERROR, 0,
                 "Truncated Stockholm alignment (missing // terminator).");
        goto done;
    }
    if (n_slots == 0) {
        evc_fail(out, EVC_VALUE_ERROR, 0,
                 "Stockholm alignment contains no sequences.");
        goto done;
    }

    long long L = slots[0].len;
    for (long long i = 1; i < n_slots; i++) {
        if (slots[i].len != L) {
            evc_fail(out, EVC_VALUE_ERROR, 0,
                     "Stockholm rows have unequal lengths.");
            goto done;
        }
    }

    seqs = (char *)malloc((size_t)(n_slots * L) + 1);
    if (seqs == NULL) {
        evc_fail(out, EVC_NO_MEMORY, 0, "reading %s", path);
        goto done;
    }
    for (long long i = 0; i < n_slots; i++) {
        if (!evc_buf_record(&ids, slots[i].id, (size_t)slots[i].idlen)) {
            evc_fail(out, EVC_NO_MEMORY, 0, "reading %s", path);
            goto done;
        }
        if (L > 0) {
            memcpy(seqs + i * L, slots[i].seq, (size_t)L);
        }
    }

    out->n = n_slots;
    out->L = L;
    out->seqs = seqs;
    out->ids = ids.data;
    out->ids_len = (long long)ids.len;
    out->markup = markup.data;
    out->markup_len = (long long)markup.len;
    out->n_markup = n_markup;
    seqs = NULL;
    ids.data = NULL;
    markup.data = NULL;

done:
    if (slots != NULL) {
        for (long long i = 0; i < n_slots; i++) {
            free(slots[i].seq);
        }
        free(slots);
    }
    free(map.entries);
    free(buf);
    free(seqs);
    free(ids.data);
    free(markup.data);
    return out->status;
}

/*
 * Single-pass FASTA/A2M reader with a plain C interface (loaded through
 * ctypes by evcouplings_torch/native/__init__.py).
 *
 *   int evc_parse_fasta(const char *path, EvcParse *out);
 *
 * One pass over the file's bytes: the ids ('\n'-terminated records) and
 * the (N, L) residue block as one contiguous buffer, which numpy views
 * as the alignment's character matrix. The semantics are the Python
 * reader's: header lines start with '>' (trailing whitespace stripped),
 * ';' lines are comments, sequence lines are concatenated with trailing
 * '\r'/whitespace stripped. A ValueError status for ragged rows (a3m
 * input: callers fall back to the insert-aware Python reader), for files
 * without any '>' and for input the strict guard refuses (io_common.h).
 */

#include "io_common.h"

static int
is_trailing_ws(unsigned char c)
{
    return c == ' ' || c == '\t' || c == '\r';
}

int
evc_parse_fasta(const char *path, EvcParse *out)
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

    /* sequence bytes can never exceed the file size */
    char *seqbuf = (char *)malloc((size_t)fsize + 1);
    EvcBuf ids = {NULL, 0, 0};
    if (seqbuf == NULL) {
        free(buf);
        return evc_fail(out, EVC_NO_MEMORY, 0, "reading %s", path);
    }

    long long seq_len = 0;     /* bytes written to seqbuf */
    long long row_start = 0;   /* start of the current row in seqbuf */
    long long L = -1;          /* row length, fixed by the first row */
    long long n_rows = 0;
    int in_record = 0;

    char *p = buf;
    char *end = buf + fsize;
    while (p < end) {
        char *nl = memchr(p, '\n', (size_t)(end - p));
        char *line_end = (nl != NULL) ? nl : end;

        if (*p == '>') {
            /* close the previous record */
            if (in_record) {
                long long row_len = seq_len - row_start;
                if (L < 0) {
                    L = row_len;
                } else if (row_len != L) {
                    evc_fail(out, EVC_VALUE_ERROR, 0,
                             "Unequal sequence lengths: %lld != %lld "
                             "(row %lld)", row_len, L, n_rows);
                    goto fail;
                }
                n_rows++;
            }
            in_record = 1;
            row_start = seq_len;

            /* header: drop '>', strip trailing whitespace */
            char *h_end = line_end;
            while (h_end > p + 1 && is_trailing_ws((unsigned char)h_end[-1]))
                h_end--;
            if (!evc_buf_record(&ids, p + 1, (size_t)(h_end - (p + 1)))) {
                evc_fail(out, EVC_NO_MEMORY, 0, "reading %s", path);
                goto fail;
            }
        } else if (*p != ';' && in_record) {
            /* sequence line: copy, stripping trailing whitespace */
            char *s_end = line_end;
            while (s_end > p && is_trailing_ws((unsigned char)s_end[-1]))
                s_end--;
            size_t n = (size_t)(s_end - p);
            memcpy(seqbuf + seq_len, p, n);
            seq_len += (long long)n;
        }

        p = (nl != NULL) ? nl + 1 : end;
    }

    if (!in_record) {
        evc_fail(out, EVC_VALUE_ERROR, 0,
                 "No FASTA records found (no '>' header)");
        goto fail;
    }
    /* close the last record */
    {
        long long row_len = seq_len - row_start;
        if (L < 0) {
            L = row_len;
        } else if (row_len != L) {
            evc_fail(out, EVC_VALUE_ERROR, 0,
                     "Unequal sequence lengths: %lld != %lld (row %lld)",
                     row_len, L, n_rows);
            goto fail;
        }
        n_rows++;
    }

    free(buf);
    out->n = n_rows;
    out->L = L;
    out->seqs = seqbuf;
    out->ids = ids.data;
    out->ids_len = (long long)ids.len;
    return EVC_OK;

fail:
    free(buf);
    free(seqbuf);
    free(ids.data);
    return out->status;
}

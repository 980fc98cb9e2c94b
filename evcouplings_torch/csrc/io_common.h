/*
 * Shared parts of the port's native alignment readers (fasta_io.c,
 * stockholm_io.c): the result record handed to Python through ctypes,
 * whole-file slurp, the strict input guard and a growable byte buffer.
 *
 * Plain C (no Python.h): a reader fills an EvcParse that the caller
 * allocates, with malloc'd blocks the caller copies out and then returns
 * with evc_parse_free. status says how the parse ended; the Python
 * wrapper (evcouplings_torch/native/__init__.py) maps it onto the
 * exception the JAX package's CPython loaders raise: EVC_OS_ERROR ->
 * OSError, EVC_VALUE_ERROR -> ValueError, EVC_NO_MEMORY -> MemoryError.
 *
 * The strict input guard: these readers are fast paths with a Python
 * fallback (on ValueError the caller re-parses with the universal-newline,
 * UTF-8-decoding Python reader), so any input whose bytes the C
 * tokenizers would read differently from Python must fail instead of
 * succeeding with another answer. evc_ascii_clean() rejects up front a
 * bare '\r' (not part of "\r\n"), the whitespace bytes that Python's
 * str.split()/rstrip() treat as separators and these space/tab
 * tokenizers do not ('\f', '\v', 0x1c-0x1f), and any non-ASCII byte.
 */

#ifndef EVC_IO_COMMON_H
#define EVC_IO_COMMON_H

#include <errno.h>
#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/types.h>

enum {
    EVC_OK = 0,
    EVC_OS_ERROR = 1,      /* err_no holds errno (0: see message) */
    EVC_VALUE_ERROR = 2,
    EVC_NO_MEMORY = 3,
};

typedef struct {
    int status;
    int err_no;
    char message[256];
    long long n;           /* rows */
    long long L;           /* columns */
    char *seqs;            /* n * L residue bytes, row after row */
    char *ids;             /* n ids, each followed by '\n' */
    long long ids_len;
    char *markup;          /* Stockholm "#..." lines, each followed by '\n' */
    long long markup_len;
    long long n_markup;
} EvcParse;

static int
evc_fail(EvcParse *out, int status, int err_no, const char *fmt, ...)
{
    va_list ap;
    out->status = status;
    out->err_no = err_no;
    va_start(ap, fmt);
    vsnprintf(out->message, sizeof(out->message), fmt, ap);
    va_end(ap);
    return status;
}

/* Returns the blocks of a parse (its record stays the caller's). Each
 * reader's library exports it. */
void
evc_parse_free(EvcParse *out)
{
    free(out->seqs);
    free(out->ids);
    free(out->markup);
    out->seqs = out->ids = out->markup = NULL;
}

/* a growable byte buffer of '\n'-terminated records */
typedef struct {
    char *data;
    size_t len;
    size_t cap;
} EvcBuf;

static int
evc_buf_record(EvcBuf *b, const char *p, size_t n)
{
    if (b->len + n + 1 > b->cap) {
        size_t cap = b->cap ? b->cap * 2 : 4096;
        while (cap < b->len + n + 1) {
            cap *= 2;
        }
        char *data = (char *)realloc(b->data, cap);
        if (data == NULL) {
            return 0;
        }
        b->data = data;
        b->cap = cap;
    }
    memcpy(b->data + b->len, p, n);
    b->len += n;
    b->data[b->len++] = '\n';
    return 1;
}

/* Read a whole file into a NUL-terminated malloc'd buffer; NULL (and the
 * record's status set) on failure. */
static char *
evc_slurp_file(const char *path, long long *size_out, EvcParse *out)
{
    FILE *fp = fopen(path, "rb");
    if (fp == NULL) {
        evc_fail(out, EVC_OS_ERROR, errno, "%s", path);
        return NULL;
    }
    /* fseeko/ftello: off_t stays 64-bit where long may be 32; errno is
     * kept before fclose, which may change it */
    if (fseeko(fp, 0, SEEK_END) != 0) {
        int saved = errno;
        fclose(fp);
        evc_fail(out, EVC_OS_ERROR, saved, "%s", path);
        return NULL;
    }
    off_t fsize = ftello(fp);
    if (fsize < 0) {
        int saved = errno;
        fclose(fp);
        evc_fail(out, EVC_OS_ERROR, saved, "%s", path);
        return NULL;
    }
    if ((unsigned long long)fsize >= (unsigned long long)(SIZE_MAX / 2)) {
        fclose(fp);
        evc_fail(out, EVC_OS_ERROR, 0, "file too large");
        return NULL;
    }
    rewind(fp);

    char *buf = (char *)malloc((size_t)fsize + 1);
    if (buf == NULL) {
        fclose(fp);
        evc_fail(out, EVC_NO_MEMORY, 0, "reading %s", path);
        return NULL;
    }
    if (fsize > 0 && fread(buf, 1, (size_t)fsize, fp) != (size_t)fsize) {
        free(buf);
        fclose(fp);
        evc_fail(out, EVC_OS_ERROR, 0, "short read");
        return NULL;
    }
    fclose(fp);
    buf[fsize] = '\0';
    *size_out = (long long)fsize;
    return buf;
}

/* 1 if the buffer holds only bytes both tokenizers agree on (see the
 * header comment); otherwise 0 with a ValueError status. */
static int
evc_ascii_clean(const char *buf, size_t n, EvcParse *out)
{
    const unsigned char *p = (const unsigned char *)buf;
    for (size_t i = 0; i < n; i++) {
        unsigned char c = p[i];
        if (c >= 0x80) {
            evc_fail(out, EVC_VALUE_ERROR, 0,
                     "non-ASCII byte: needs the UTF-8-decoding Python "
                     "reader");
            return 0;
        }
        if (c == '\r') {
            if (i + 1 >= n || p[i + 1] != '\n') {
                evc_fail(out, EVC_VALUE_ERROR, 0,
                         "bare '\\r' line ending: needs the "
                         "universal-newline Python reader");
                return 0;
            }
            i++;  /* part of CRLF: fine */
        } else if (c == '\f' || c == '\v' || (c >= 0x1c && c <= 0x1f)) {
            /* \x1c-\x1f (FS/GS/RS/US) are whitespace to Python's
             * str.split()/rstrip() too */
            evc_fail(out, EVC_VALUE_ERROR, 0,
                     "whitespace control byte: Python's str.split() "
                     "treats it as a separator, this tokenizer does not");
            return 0;
        }
    }
    return 1;
}

#endif /* EVC_IO_COMMON_H */

// Fast FASTQ -> packed code/qual arrays (host ingest hot path).
//
// Native replacement for the reference's input-prep conversion layer
// (ref: PrepareAllPathsInputs.pl + src/util Fastb/Qualb converters,
// SURVEY.md §2.6): parses FASTQ at memory bandwidth into the framework's
// uint8 code matrix (A=0 C=1 G=2 T=3, N/pad=4), phred quals, and lengths.
// Exposed via a C ABI for ctypes; built by allpathslg_tpu_torch.native.build.
//
// Two-pass protocol: fastq_scan() sizes the arrays, fastq_load() fills
// caller-allocated buffers. Plain files only (gzip falls back to Python).

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct LineReader {
    FILE* f;
    std::vector<char> buf;
    explicit LineReader(FILE* f_) : f(f_), buf(1 << 20) {}
    // returns length of line (without newline), or -1 on EOF
    long next(char** out) {
        if (!fgets(buf.data(), (int)buf.size(), f)) return -1;
        long n = (long)strlen(buf.data());
        while (n > 0 && (buf[n - 1] == '\n' || buf[n - 1] == '\r')) --n;
        buf[n] = 0;
        *out = buf.data();
        return n;
    }
};

unsigned char code_of[256];

struct CodeInit {
    CodeInit() {
        memset(code_of, 4, sizeof(code_of));
        code_of['A'] = code_of['a'] = 0;
        code_of['C'] = code_of['c'] = 1;
        code_of['G'] = code_of['g'] = 2;
        code_of['T'] = code_of['t'] = 3;
    }
} code_init;

}  // namespace

extern "C" {

// First pass: count reads and the maximum read length.
// Returns 0 on success, nonzero errno-style code on failure.
int fastq_scan(const char* path, long* n_reads, long* max_len) {
    FILE* f = fopen(path, "rb");
    if (!f) return 1;
    LineReader lr(f);
    char* line;
    long n = 0, ml = 0;
    while (true) {
        long h = lr.next(&line);
        if (h < 0) break;
        if (h == 0) continue;
        if (line[0] != '@') { fclose(f); return 2; }
        long s = lr.next(&line);
        if (s < 0) { fclose(f); return 2; }
        if (s > ml) ml = s;
        if (lr.next(&line) < 0) { fclose(f); return 2; }  // '+'
        if (lr.next(&line) < 0) { fclose(f); return 2; }  // quals
        ++n;
    }
    fclose(f);
    *n_reads = n;
    *max_len = ml;
    return 0;
}

// Second pass: fill codes[n_reads*max_len] (pre-filled or not; we write
// pad=4 beyond each read), quals likewise (0 beyond), lengths[n_reads].
int fastq_load(const char* path, unsigned char* codes, unsigned char* quals,
               int* lengths, long n_reads, long max_len) {
    FILE* f = fopen(path, "rb");
    if (!f) return 1;
    LineReader lr(f);
    char* line;
    long i = 0;
    while (i < n_reads) {
        long h = lr.next(&line);
        if (h < 0) break;
        if (h == 0) continue;
        long s = lr.next(&line);
        if (s < 0) { fclose(f); return 2; }
        long L = s > max_len ? max_len : s;
        unsigned char* crow = codes + i * max_len;
        for (long j = 0; j < L; ++j) crow[j] = code_of[(unsigned char)line[j]];
        for (long j = L; j < max_len; ++j) crow[j] = 4;
        lengths[i] = (int)L;
        if (lr.next(&line) < 0) { fclose(f); return 2; }  // '+'
        long q = lr.next(&line);
        if (q < 0) { fclose(f); return 2; }
        unsigned char* qrow = quals + i * max_len;
        long Q = q > L ? L : q;
        for (long j = 0; j < Q; ++j) {
            int v = (unsigned char)line[j] - 33;
            qrow[j] = (unsigned char)(v < 0 ? 0 : (v > 60 ? 60 : v));
        }
        for (long j = Q; j < max_len; ++j) qrow[j] = 0;
        ++i;
    }
    fclose(f);
    return i == n_reads ? 0 : 3;
}

}  // extern "C"

// Plain SAM -> code/qual arrays and mate pairs (host ingest hot path).
//
// The port's own native reader for io/sam.read_sam: the same records, in
// the same order, as the Python parser (io/sam._parse) gives, at a cost of
// two passes over a memory-mapped file. Codes are A=0 C=1 G=2 T=3 with
// anything else and padding 4; quals are the byte minus 33, wrapped in
// uint8, with `*` read as 30 for every base and padding 0. A 0x10 record
// is restored to its sequenced orientation (codes reverse-complemented,
// 4 kept as 4; quals reversed). Mates pair as the Python dict pairs them:
// look up (qname, 1 if 0x40 else 0); on a hit pop it and append (other,
// idx) if 0x80 else (idx, other); on a miss register (qname, 0 if 0x40
// else 1), overwriting an earlier entry.
//
// Exposed through a C ABI for ctypes; built by allpathslg_tpu_torch.native.
// build. Two-pass protocol: sam_scan() sizes the arrays, sam_load() fills
// caller-allocated buffers. Either returns nonzero (the caller then runs
// the Python parser) where the Python text-mode parse would read the file
// in a way this reader does not mirror: a '\r' (universal newlines), a
// byte >= 0x80 (locale decoding), a FLAG that is not plain decimal digits,
// a QUAL other than `*` whose length is not SEQ's, no kept record, or a
// count or length beyond int32.

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <climits>
#include <cstdint>
#include <cstring>
#include <string_view>
#include <unordered_map>

namespace {

enum Rc { OK = 0, NO_FILE = 1, DECLINE = 2, CHANGED = 3 };

constexpr uint64_t FLAG_PAIRED = 0x1, FLAG_RC = 0x10, FLAG_FIRST = 0x40,
                   FLAG_SECOND = 0x80, FLAG_SKIP = 0x100 | 0x800,
                   FLAG_DUP = 0x400;

unsigned char code_of[256];
const unsigned char rc_of[5] = {3, 2, 1, 0, 4};

struct CodeInit {
    CodeInit() {
        memset(code_of, 4, sizeof(code_of));
        code_of['A'] = code_of['a'] = 0;
        code_of['C'] = code_of['c'] = 1;
        code_of['G'] = code_of['g'] = 2;
        code_of['T'] = code_of['t'] = 3;
    }
} code_init;

// The whole file, read-only; an empty or unmappable file maps to nothing.
struct Mapped {
    const char* p = nullptr;
    size_t n = 0;
    explicit Mapped(const char* path) {
        int fd = open(path, O_RDONLY);
        if (fd < 0) return;
        struct stat st;
        if (fstat(fd, &st) == 0 && S_ISREG(st.st_mode) && st.st_size > 0) {
            void* m = mmap(nullptr, (size_t)st.st_size, PROT_READ,
                           MAP_PRIVATE, fd, 0);
            if (m != MAP_FAILED) {
                madvise(m, (size_t)st.st_size, MADV_SEQUENTIAL);
                p = (const char*)m;
                n = (size_t)st.st_size;
            }
        }
        close(fd);
    }
    ~Mapped() {
        if (p) munmap((void*)p, n);
    }
};

// No '\r' and no byte >= 0x80 anywhere: then every line the Python parse
// sees ends at a '\n' and every byte is one character.
bool plain_ascii(const char* p, size_t n) {
    unsigned char bad = 0;
    for (size_t i = 0; i < n; ++i) {
        unsigned char c = (unsigned char)p[i];
        bad |= (unsigned char)((c & 0x80) | (c == '\r'));
    }
    return bad == 0;
}

struct Record {
    std::string_view qname, seq, qual;
    uint64_t flag;
};

// Calls on_kept(record) for each record the Python parser keeps, in file
// order. Returns OK, or DECLINE at the first line it does not mirror.
template <class F>
int walk(const char* p, size_t n, bool keep_duplicates, F&& on_kept) {
    const char* end = p + n;
    while (p < end) {
        const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
        const char* line_end = nl ? nl : end;
        const char* line = p;
        p = nl ? nl + 1 : end;
        if (line == line_end || line[0] == '@') continue;
        // fields 0..10: the 11th ends at the next tab or the line's end
        const char* start[11];
        const char* stop[11];
        const char* f = line;
        int k = 0;
        for (; k < 11; ++k) {
            const char* t =
                (const char*)memchr(f, '\t', (size_t)(line_end - f));
            start[k] = f;
            stop[k] = t ? t : line_end;
            if (!t) {
                ++k;
                break;
            }
            f = t + 1;
        }
        if (k < 11) continue;
        if (start[1] == stop[1]) return DECLINE;
        uint64_t flag = 0;  // the low bits are exact even where it wraps
        for (const char* c = start[1]; c < stop[1]; ++c) {
            if (*c < '0' || *c > '9') return DECLINE;
            flag = flag * 10 + (uint64_t)(*c - '0');
        }
        if (flag & FLAG_SKIP) continue;
        if (!keep_duplicates && (flag & FLAG_DUP)) continue;
        Record r{{start[0], (size_t)(stop[0] - start[0])},
                 {start[9], (size_t)(stop[9] - start[9])},
                 {start[10], (size_t)(stop[10] - start[10])},
                 flag};
        if (r.seq == "*") continue;
        if (r.qual != "*" && r.qual.size() != r.seq.size()) return DECLINE;
        if (r.seq.size() > (size_t)INT_MAX) return DECLINE;
        int rc = on_kept(r);
        if (rc != OK) return rc;
    }
    return OK;
}

}  // namespace

extern "C" {

// First pass: the kept records' count, their longest SEQ, and the bytes of
// their QNAMEs joined by '\n'. 0 on success.
int sam_scan(const char* path, int keep_duplicates, long* n_reads,
             long* max_len, long* name_bytes) {
    Mapped m(path);
    if (!m.p) return NO_FILE;
    if (!plain_ascii(m.p, m.n)) return DECLINE;
    long n = 0, ml = 0, nb = 0;
    int rc = walk(m.p, m.n, keep_duplicates != 0, [&](const Record& r) {
        if (n == INT_MAX) return (int)DECLINE;
        ++n;
        if ((long)r.seq.size() > ml) ml = (long)r.seq.size();
        nb += (long)r.qname.size() + 1;
        return (int)OK;
    });
    if (rc != OK) return rc;
    if (n == 0) return DECLINE;
    *n_reads = n;
    *max_len = ml;
    *name_bytes = nb - 1;
    return OK;
}

// Second pass: fill codes and quals [n_reads, max_len] (padding written
// here), lengths [n_reads], pairs [max_pairs, 2] (the count in *n_pairs)
// and names [name_bytes]. 3 if the file no longer gives the first pass's
// sizes.
int sam_load(const char* path, int keep_duplicates, unsigned char* codes,
             unsigned char* quals, int* lengths, int* pairs, long max_pairs,
             long* n_pairs, char* names, long n_reads, long max_len,
             long name_bytes) {
    Mapped m(path);
    if (!m.p) return NO_FILE;
    if (!plain_ascii(m.p, m.n)) return DECLINE;
    // mate_slot[s][qname]: the record waiting in slot s for its mate
    std::unordered_map<std::string_view, int> mate_slot[2];
    long i = 0, np = 0, nb = 0;
    int rc = walk(m.p, m.n, keep_duplicates != 0, [&](const Record& r) {
        long L = (long)r.seq.size();
        if (i == n_reads || L > max_len) return (int)CHANGED;
        long nb_next = nb + (i ? 1 : 0) + (long)r.qname.size();
        if (nb_next > name_bytes) return (int)CHANGED;
        unsigned char* crow = codes + i * max_len;
        unsigned char* qrow = quals + i * max_len;
        const unsigned char* s = (const unsigned char*)r.seq.data();
        const unsigned char* q = (const unsigned char*)r.qual.data();
        bool star = r.qual == "*";
        if (r.flag & FLAG_RC) {
            for (long j = 0; j < L; ++j) crow[j] = rc_of[code_of[s[L - 1 - j]]];
            for (long j = 0; j < L; ++j)
                qrow[j] = star ? 30 : (unsigned char)(q[L - 1 - j] - 33);
        } else {
            for (long j = 0; j < L; ++j) crow[j] = code_of[s[j]];
            for (long j = 0; j < L; ++j)
                qrow[j] = star ? 30 : (unsigned char)(q[j] - 33);
        }
        memset(crow + L, 4, (size_t)(max_len - L));
        memset(qrow + L, 0, (size_t)(max_len - L));
        lengths[i] = (int)L;
        if (i) names[nb++] = '\n';
        memcpy(names + nb, r.qname.data(), r.qname.size());
        nb = nb_next;
        if (r.flag & FLAG_PAIRED) {
            bool first = (r.flag & FLAG_FIRST) != 0;
            auto& mine = mate_slot[first ? 1 : 0];
            auto hit = mine.find(r.qname);
            if (hit != mine.end()) {
                if (np == max_pairs) return (int)CHANGED;
                int other = hit->second;
                mine.erase(hit);
                bool second = (r.flag & FLAG_SECOND) != 0;
                pairs[2 * np] = second ? other : (int)i;
                pairs[2 * np + 1] = second ? (int)i : other;
                ++np;
            } else {
                mate_slot[first ? 0 : 1][r.qname] = (int)i;
            }
        }
        ++i;
        return (int)OK;
    });
    if (rc != OK) return rc;
    if (i != n_reads || nb != name_bytes) return CHANGED;
    *n_pairs = np;
    return OK;
}

}  // extern "C"

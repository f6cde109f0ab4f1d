// Native FASTQ/FASTA batch reader (kseq.h + kopen.c equivalent,
// SURVEY.md §2 row 21).  The reference keeps its record parser in C
// because line-at-a-time Python cannot feed an accelerator at 1e5+
// reads/s; this reader decodes gzip (zlib's gzopen handles plain
// files transparently), splits records, and 2-bit-encodes bases in
// one pass, handing whole batches to Python as blob + offset arrays.
//
// ABI (all int64 unless noted):
//   tpubwa_fq_open(path) -> handle (NULL on failure)
//   tpubwa_fq_read_batch(h, max_records, max_bases,
//       seq_buf u8[seq_cap], seq_off[max_records+1],
//       name_buf, name_cap, name_off[max_records+1],
//       qual_buf, qual_cap, qual_off[max_records+1],
//       comm_buf, comm_cap, comm_off[max_records+1],
//       flags u8[max_records])            // bit0: has qual
//     -> n records (0 at EOF), or -1 on malformed input
//   tpubwa_fq_close(h)
//
// A record that would overflow any cap is held over to the next call
// (the parser keeps one pending record), so callers can size buffers
// for the common case.

#include <cstdint>
#include <cstring>
#include <string>
#include <zlib.h>

namespace {

typedef int64_t i64;
typedef uint8_t u8;

struct GzLineReader {
    gzFile f = nullptr;
    char buf[1 << 16];
    int len = 0, pos = 0;
    bool eof = false;

    bool getline(std::string* out) {
        out->clear();
        while (true) {
            if (pos >= len) {
                if (eof) return !out->empty();
                len = gzread(f, buf, sizeof buf);
                pos = 0;
                if (len <= 0) { eof = true; return !out->empty(); }
            }
            char* nl = (char*)memchr(buf + pos, '\n', len - pos);
            if (nl) {
                out->append(buf + pos, nl - (buf + pos));
                pos = (int)(nl - buf) + 1;
                break;
            }
            out->append(buf + pos, len - pos);
            pos = len;
        }
        if (!out->empty() && out->back() == '\r') out->pop_back();
        return true;
    }
};

struct Record {
    std::string name, comment, qual;
    std::string seq;   // already encoded 0..4
    bool has_qual = false;
};

struct Reader {
    GzLineReader in;
    std::string line;        // current lookahead line ("" = none)
    bool have_line = false;
    Record pending;          // held-over record (caps overflow)
    bool have_pending = false;
    bool error = false;
};

u8 NT4[256];
struct Nt4Init {
    Nt4Init() {
        memset(NT4, 4, sizeof NT4);
        const char* b = "ACGTacgt";
        const u8 c[] = {0, 1, 2, 3, 0, 1, 2, 3};
        for (int i = 0; i < 8; ++i) NT4[(u8)b[i]] = c[i];
    }
} nt4_init;

bool next_line(Reader* r, std::string* out) {
    if (r->have_line) {
        *out = std::move(r->line);
        r->have_line = false;
        return true;
    }
    return r->in.getline(out);
}

void push_back_line(Reader* r, std::string line) {
    r->line = std::move(line);
    r->have_line = true;
}

// parse one record into rec; returns 1 ok, 0 EOF, -1 malformed
int parse_record(Reader* r, Record* rec) {
    std::string line;
    do {
        if (!next_line(r, &line)) return 0;
    } while (line.empty());
    rec->name.clear(); rec->comment.clear();
    rec->seq.clear(); rec->qual.clear();
    bool fastq = line[0] == '@';
    if (!fastq && line[0] != '>') return -1;
    size_t sp = line.find_first_of(" \t");
    if (sp == std::string::npos) {
        rec->name.assign(line, 1, line.size() - 1);
    } else {
        rec->name.assign(line, 1, sp - 1);
        size_t cs = line.find_first_not_of(" \t", sp);
        if (cs != std::string::npos)
            rec->comment.assign(line, cs, line.size() - cs);
    }
    if (fastq) {
        // sequence lines until the '+' separator
        while (next_line(r, &line)) {
            if (!line.empty() && line[0] == '+') break;
            for (char ch : line) rec->seq.push_back((char)NT4[(u8)ch]);
        }
        // quality lines until length matches
        while (rec->qual.size() < rec->seq.size()
               && next_line(r, &line))
            rec->qual += line;
        if (rec->qual.size() != rec->seq.size()) return -1;
        rec->has_qual = true;
    } else {
        while (next_line(r, &line)) {
            if (!line.empty() && (line[0] == '>' || line[0] == '@')) {
                push_back_line(r, std::move(line));
                break;
            }
            for (char ch : line) rec->seq.push_back((char)NT4[(u8)ch]);
        }
        rec->has_qual = false;
    }
    return 1;
}

}  // namespace

extern "C" {

void* tpubwa_fq_open(const char* path) {
    gzFile f = gzopen(path, "rb");
    if (!f) return nullptr;
    gzbuffer(f, 1 << 20);
    Reader* r = new Reader();
    r->in.f = f;
    return r;
}

void tpubwa_fq_close(void* h) {
    Reader* r = (Reader*)h;
    if (r->in.f) gzclose(r->in.f);
    delete r;
}

// Seek to a DECOMPRESSED byte offset (must be a record boundary).
// For plain files this is an lseek; for gz, zlib inflates forward
// (~300 MB/s) — still far cheaper than parsing records.  Returns 0
// on success.
i64 tpubwa_fq_seek(void* h, i64 off) {
    Reader* r = (Reader*)h;
    if (gzseek(r->in.f, (z_off_t)off, SEEK_SET) < 0) return -1;
    r->in.len = r->in.pos = 0;
    r->in.eof = false;
    r->have_line = false;
    r->have_pending = false;
    r->error = false;
    return 0;
}

i64 tpubwa_fq_read_batch(void* h, i64 max_records, i64 max_bases,
                         u8* seq_buf, i64 seq_cap, i64* seq_off,
                         char* name_buf, i64 name_cap, i64* name_off,
                         char* qual_buf, i64 qual_cap, i64* qual_off,
                         char* comm_buf, i64 comm_cap, i64* comm_off,
                         u8* flags) {
    Reader* r = (Reader*)h;
    if (r->error) return -1;
    i64 n = 0, bases = 0;
    i64 so = 0, no = 0, qo = 0, co = 0;
    seq_off[0] = name_off[0] = qual_off[0] = comm_off[0] = 0;
    while (n < max_records && bases < max_bases) {
        Record rec;
        Record* rp;
        if (r->have_pending) {
            rp = &r->pending;
        } else {
            int rc = parse_record(r, &rec);
            if (rc == 0) break;
            if (rc < 0) { r->error = true; return n ? n : -1; }
            rp = &rec;
        }
        if (so + (i64)rp->seq.size() > seq_cap
            || no + (i64)rp->name.size() > name_cap
            || qo + (i64)rp->qual.size() > qual_cap
            || co + (i64)rp->comment.size() > comm_cap) {
            if (rp != &r->pending) {
                r->pending = std::move(*rp);
                r->have_pending = true;
            }
            break;  // held over for the next call
        }
        if (rp == &r->pending) r->have_pending = false;
        memcpy(seq_buf + so, rp->seq.data(), rp->seq.size());
        so += rp->seq.size();
        memcpy(name_buf + no, rp->name.data(), rp->name.size());
        no += rp->name.size();
        memcpy(qual_buf + qo, rp->qual.data(), rp->qual.size());
        qo += rp->qual.size();
        memcpy(comm_buf + co, rp->comment.data(), rp->comment.size());
        co += rp->comment.size();
        flags[n] = rp->has_qual ? 1 : 0;
        bases += (i64)rp->seq.size();
        ++n;
        seq_off[n] = so; name_off[n] = no;
        qual_off[n] = qo; comm_off[n] = co;
    }
    return n;
}

}  // extern "C"

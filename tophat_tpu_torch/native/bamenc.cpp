// Copy of tophat_tpu/native/bamenc.cpp (host code), with mate columns and
// the record emitter added.
// Columnar BAM record assembler — the native form of
// io/bam.encode_records_columns (role of samtools bam_write1,
// reference src/samtools-0.1.18/bam.c) — and the record emitter of both
// output writers (io/emit.py): one walk over the record table writes each
// record's accepted_hits.sam line and its BAM record. The Python caller
// supplies flat column buffers; nothing here allocates.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 bamenc.cpp -o libbamenc.so

#include <cstdint>
#include <cstring>

namespace {

inline int reg2bin(int64_t beg, int64_t end) {
    --end;
    if (beg >= (1LL << 29) || end >= (1LL << 29)) return 0;  // pseudo-bin
    if (beg >> 14 == end >> 14) return ((1 << 15) - 1) / 7 + (int)(beg >> 14);
    if (beg >> 17 == end >> 17) return ((1 << 12) - 1) / 7 + (int)(beg >> 17);
    if (beg >> 20 == end >> 20) return ((1 << 9) - 1) / 7 + (int)(beg >> 20);
    if (beg >> 23 == end >> 23) return ((1 << 6) - 1) / 7 + (int)(beg >> 23);
    if (beg >> 26 == end >> 26) return ((1 << 3) - 1) / 7 + (int)(beg >> 26);
    return 0;
}

// ASCII base -> BAM 4-bit code ("=ACMGRSVTWYHKDBN"; unknown -> N, 15) and
// ASCII base -> its complement (ACGTN and lowercase; others unchanged)
uint8_t seq4_lut[256];
uint8_t comp_lut[256];
bool tables_ready = false;

void init_tables() {
    const char* code = "=ACMGRSVTWYHKDBN";
    for (int i = 0; i < 256; ++i) {
        seq4_lut[i] = 15;
        comp_lut[i] = (uint8_t)i;
    }
    for (int i = 0; i < 16; ++i) {
        seq4_lut[(uint8_t)code[i]] = (uint8_t)i;
        seq4_lut[(uint8_t)(code[i] | 0x20)] = (uint8_t)i;  // lowercase
    }
    const char* fwd = "ACGTNacgtn";
    const char* rev = "TGCANtgcan";
    for (int i = 0; i < 10; ++i) comp_lut[(uint8_t)fwd[i]] = (uint8_t)rev[i];
    tables_ready = true;
}

inline uint8_t* put_i32(uint8_t* p, int32_t v) {
    std::memcpy(p, &v, 4);
    return p + 4;
}

inline uint8_t* put_u16(uint8_t* p, uint16_t v) {
    std::memcpy(p, &v, 2);
    return p + 2;
}

inline uint8_t* put_dec(uint8_t* p, int64_t v) {
    char buf[24];
    int k = 0;
    uint64_t u = v < 0 ? 0 - (uint64_t)v : (uint64_t)v;
    do {
        buf[k++] = (char)('0' + u % 10);
        u /= 10;
    } while (u);
    if (v < 0) *p++ = '-';
    while (k) *p++ = (uint8_t)buf[--k];
    return p;
}

inline uint8_t* put_bytes(uint8_t* p, const uint8_t* s, int64_t n) {
    std::memcpy(p, s, (size_t)n);
    return p + n;
}

// A BAM record up to and including its qualities; the caller appends the
// tags and then patches block_size (the record's first 4 bytes).
// seq/qual are in read order; reverse stores them reverse-complemented and
// reversed. n_qual == 0: no qualities (0xFF fill, SAM "*"); else n_qual
// bytes of phred33, 0xFF past them.
uint8_t* put_bam_core(uint8_t* p, int32_t ref_id, int32_t pos, int64_t end,
                      int32_t mapq, int32_t flag, int32_t ref_id2,
                      int32_t pos2, int32_t tlen, const uint8_t* name,
                      int64_t name_len, const uint32_t* cig, int64_t n_cig,
                      const uint8_t* seq, int64_t l_seq, const uint8_t* qual,
                      int64_t n_qual, bool reverse) {
    p = put_i32(p, 0);  // block_size, patched by the caller
    p = put_i32(p, ref_id);
    p = put_i32(p, pos);
    *p++ = (uint8_t)(name_len + 1);
    *p++ = (uint8_t)mapq;
    p = put_u16(p, (uint16_t)reg2bin(pos, end));
    p = put_u16(p, (uint16_t)n_cig);
    p = put_u16(p, (uint16_t)flag);
    p = put_i32(p, (int32_t)l_seq);
    p = put_i32(p, ref_id2);
    p = put_i32(p, pos2);
    p = put_i32(p, tlen);
    p = put_bytes(p, name, name_len);
    *p++ = 0;
    p = put_bytes(p, reinterpret_cast<const uint8_t*>(cig), 4 * n_cig);
    auto base = [&](int64_t j) -> uint8_t {
        return reverse ? seq4_lut[comp_lut[seq[l_seq - 1 - j]]]
                       : seq4_lut[seq[j]];
    };
    for (int64_t j = 0; j + 1 < l_seq; j += 2)
        *p++ = (uint8_t)((base(j) << 4) | base(j + 1));
    if (l_seq & 1) *p++ = (uint8_t)(base(l_seq - 1) << 4);
    if (n_qual == 0) {
        std::memset(p, 0xFF, (size_t)l_seq);
        p += l_seq;
    } else {
        int64_t m = n_qual < l_seq ? n_qual : l_seq;
        for (int64_t j = 0; j < m; ++j)
            *p++ = (uint8_t)((reverse ? qual[n_qual - 1 - j] : qual[j]) - 33);
        for (int64_t j = m; j < l_seq; ++j) *p++ = 0xFF;
    }
    return p;
}

inline void patch_block_size(uint8_t* rec, uint8_t* p) {
    put_i32(rec, (int32_t)(p - rec - 4));
}

// the record table's columns, record-major (io/emit.py COLUMNS)
enum {
    C_READ, C_SEQ, C_RL, C_FLAG, C_CID, C_POS, C_MAPQ, C_NM, C_NH, C_XS,
    C_MCID, C_MPOS, C_TLEN, NCOL
};

const char CIGAR_CHARS[] = "MIDNSHP=X";

}  // namespace

extern "C" {

// Returns bytes written, or -1 if out_cap would be exceeded.
// names: blob without separators, name i at [name_off[i], name_off[i+1]).
// seq/qual share seq_off (ASCII, phred33); no_qual[i] -> 0xFF fill.
// tags: pre-encoded blob, record i at [tag_off[i], tag_off[i+1]).
int64_t bam_encode_records(
    int64_t n,
    const uint8_t* names, const int64_t* name_off,
    const int32_t* flag, const int32_t* ref_id, const int32_t* pos,
    const int32_t* end, const int32_t* mapq,
    const int32_t* ref_id2, const int32_t* pos2, const int32_t* tlen,
    const uint32_t* cig, const int64_t* cig_off,
    const uint8_t* seq, const int64_t* seq_off,
    const uint8_t* qual, const uint8_t* no_qual,
    const uint8_t* tags, const int64_t* tag_off,
    uint8_t* out, int64_t out_cap) {
    if (!tables_ready) init_tables();
    uint8_t* p = out;
    uint8_t* lim = out + out_cap;
    for (int64_t i = 0; i < n; ++i) {
        int64_t name_len = name_off[i + 1] - name_off[i];
        int64_t n_cig = cig_off[i + 1] - cig_off[i];
        int64_t l_seq = seq_off[i + 1] - seq_off[i];
        int64_t tag_len = tag_off[i + 1] - tag_off[i];
        int64_t rec = 36 + name_len + 1 + 4 * n_cig + (l_seq + 1) / 2 + l_seq
                      + tag_len;
        if (p + rec > lim) return -1;
        uint8_t* start = p;
        p = put_bam_core(p, ref_id[i], pos[i], end[i], mapq[i], flag[i],
                         ref_id2[i], pos2[i], tlen[i], names + name_off[i],
                         name_len, cig + cig_off[i], n_cig,
                         seq + seq_off[i], l_seq, qual + seq_off[i],
                         no_qual[i] ? 0 : l_seq, false);
        p = put_bytes(p, tags + tag_off[i], tag_len);
        patch_block_size(start, p);
    }
    return p - out;
}

// The record emitter: record i's accepted_hits.sam line into sam_out and
// its BAM record into bam_out, for every row of the table `cols` (n x NCOL,
// int64, record-major):
//   C_READ  the record's read in the reads' global index (names, quals)
//   C_SEQ   offset of the read's ASCII bases in `seq`; C_RL its length
//   C_FLAG, C_CID (contig), C_POS (0-based), C_MAPQ, C_NM, C_NH
//   C_XS    '+' or '-' for an XS:A tag, 0 for none
//   C_MCID  the mate's contig (-1: none; RNEXT "*", "=" or its name),
//   C_MPOS  its 0-based position (-1: none), C_TLEN
// cig: packed BAM CIGAR ops, record i's at [cig_off[i], cig_off[i+1])
// (zero-length ops are kept in BAM, left out of the SAM text).
// qual: blob, read r's at [qual_off[r], qual_off[r+1]), cut to the read's
// length; none -> "*" / 0xFF. Reverse-strand records (flag 0x10) store
// the reverse complement and reversed qualities.
// refs: contig names, contig c at [ref_off[c], ref_off[c+1]).
// xsam/xbam: each record's extra tags, a SAM fragment (leading tab) and
// its BAM encoding; rg_sam/rg_bam: the read group's tag, last on every
// record (empty for none).
// Writes the SAM bytes' length to *sam_len and returns the BAM bytes'
// length, or -1 if a buffer's capacity would be exceeded.
int64_t emit_records(
    int64_t n, const int64_t* cols,
    const uint32_t* cig, const int64_t* cig_off,
    const uint8_t* names, const int64_t* name_off,
    const uint8_t* seq, const uint8_t* qual, const int64_t* qual_off,
    const uint8_t* refs, const int64_t* ref_off,
    const uint8_t* xsam, const int64_t* xsam_off,
    const uint8_t* xbam, const int64_t* xbam_off,
    const uint8_t* rg_sam, int64_t rg_sam_len,
    const uint8_t* rg_bam, int64_t rg_bam_len,
    uint8_t* sam_out, int64_t sam_cap, int64_t* sam_len,
    uint8_t* bam_out, int64_t bam_cap) {
    if (!tables_ready) init_tables();
    uint8_t* s = sam_out;
    uint8_t* s_lim = sam_out + sam_cap;
    uint8_t* b = bam_out;
    uint8_t* b_lim = bam_out + bam_cap;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t* c = cols + i * NCOL;
        int64_t r = c[C_READ];
        const uint8_t* name = names + name_off[r];
        int64_t name_len = name_off[r + 1] - name_off[r];
        const uint8_t* sq = seq + c[C_SEQ];
        int64_t rl = c[C_RL];
        const uint8_t* q = qual + qual_off[r];
        int64_t n_qual = qual_off[r + 1] - qual_off[r];
        if (n_qual > rl) n_qual = rl;
        if (n_qual == 1 && q[0] == '*') n_qual = 0;  // SAM's "no qualities"
        int64_t cid = c[C_CID], mcid = c[C_MCID];
        const uint8_t* ref = refs + ref_off[cid];
        int64_t ref_len = ref_off[cid + 1] - ref_off[cid];
        const uint32_t* cg = cig + cig_off[i];
        int64_t n_cig = cig_off[i + 1] - cig_off[i];
        int64_t xs_len = xsam_off[i + 1] - xsam_off[i];
        int64_t xb_len = xbam_off[i + 1] - xbam_off[i];
        bool reverse = (c[C_FLAG] & 0x10) != 0;
        int64_t mref_len = (mcid >= 0 && mcid != cid)
                           ? ref_off[mcid + 1] - ref_off[mcid] : 1;

        int64_t need_s = name_len + ref_len + mref_len + 12 * n_cig + 2 * rl
                         + xs_len + rg_sam_len + 256;
        int64_t need_b = 36 + name_len + 1 + 4 * n_cig + (rl + 1) / 2 + rl
                         + 7 + 4 + 7 + xb_len + rg_bam_len;
        if (s + need_s > s_lim || b + need_b > b_lim) return -1;

        // SAM: QNAME FLAG RNAME POS MAPQ CIGAR RNEXT PNEXT TLEN SEQ QUAL
        // NM:i [XS:A] NH:i [extra] [RG:Z]
        s = put_bytes(s, name, name_len);
        *s++ = '\t';
        s = put_dec(s, c[C_FLAG]);
        *s++ = '\t';
        s = put_bytes(s, ref, ref_len);
        *s++ = '\t';
        s = put_dec(s, c[C_POS] + 1);
        *s++ = '\t';
        s = put_dec(s, c[C_MAPQ]);
        *s++ = '\t';
        uint8_t* cig_start = s;
        int64_t span = 0;
        for (int64_t j = 0; j < n_cig; ++j) {
            uint32_t op = cg[j] & 0xF;
            int64_t len = cg[j] >> 4;
            if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
                span += len;
            if (len > 0) {
                s = put_dec(s, len);
                *s++ = (uint8_t)CIGAR_CHARS[op < 9 ? op : 0];
            }
        }
        if (s == cig_start) *s++ = '*';
        *s++ = '\t';
        if (mcid < 0) {
            *s++ = '*';
        } else if (mcid == cid) {
            *s++ = '=';
        } else {
            s = put_bytes(s, refs + ref_off[mcid], mref_len);
        }
        *s++ = '\t';
        s = put_dec(s, c[C_MPOS] >= 0 ? c[C_MPOS] + 1 : 0);
        *s++ = '\t';
        s = put_dec(s, c[C_TLEN]);
        *s++ = '\t';
        if (reverse) {
            for (int64_t j = 0; j < rl; ++j) *s++ = comp_lut[sq[rl - 1 - j]];
        } else {
            s = put_bytes(s, sq, rl);
        }
        *s++ = '\t';
        if (n_qual == 0) {
            *s++ = '*';
        } else if (reverse) {
            for (int64_t j = 0; j < n_qual; ++j) *s++ = q[n_qual - 1 - j];
        } else {
            s = put_bytes(s, q, n_qual);
        }
        std::memcpy(s, "\tNM:i:", 6);
        s = put_dec(s + 6, c[C_NM]);
        if (c[C_XS]) {
            std::memcpy(s, "\tXS:A:", 6);
            s += 6;
            *s++ = (uint8_t)c[C_XS];
        }
        std::memcpy(s, "\tNH:i:", 6);
        s = put_dec(s + 6, c[C_NH]);
        s = put_bytes(s, xsam + xsam_off[i], xs_len);
        s = put_bytes(s, rg_sam, rg_sam_len);
        *s++ = '\n';

        // BAM: the same record; the mate's position only on its own contig
        uint8_t* start = b;
        b = put_bam_core(b, (int32_t)cid, (int32_t)c[C_POS],
                         c[C_POS] + (span > 1 ? span : 1),
                         (int32_t)c[C_MAPQ], (int32_t)c[C_FLAG],
                         (int32_t)mcid,
                         (int32_t)(mcid == cid ? c[C_MPOS] : -1),
                         (int32_t)c[C_TLEN], name, name_len, cg, n_cig, sq,
                         rl, q, n_qual, reverse);
        std::memcpy(b, "NMi", 3);
        b = put_i32(b + 3, (int32_t)c[C_NM]);
        if (c[C_XS]) {
            std::memcpy(b, "XSA", 3);
            b += 3;
            *b++ = (uint8_t)c[C_XS];
        }
        std::memcpy(b, "NHi", 3);
        b = put_i32(b + 3, (int32_t)c[C_NH]);
        b = put_bytes(b, xbam + xbam_off[i], xb_len);
        b = put_bytes(b, rg_bam, rg_bam_len);
        patch_block_size(start, b);
    }
    *sam_len = s - sam_out;
    return b - bam_out;
}

}  // extern "C"

// Copy of tophat_tpu/native/bamenc.cpp (host code), unchanged below this line.
// Columnar BAM record assembler — the native form of
// io/bam.encode_records_columns (role of samtools bam_write1,
// reference src/samtools-0.1.18/bam.c). The Python caller supplies flat
// column buffers; this walks them once and emits the packed record blob
// at C speed (~100 ns/record vs ~9 us for the numpy ragged scatters).
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

// ASCII base -> BAM 4-bit code ("=ACMGRSVTWYHKDBN"); unknown -> N (15)
const uint8_t SEQ4[256] = {
    // initialised in init_tables()
};

uint8_t seq4_lut[256];
bool tables_ready = false;

void init_tables() {
    const char* code = "=ACMGRSVTWYHKDBN";
    for (int i = 0; i < 256; ++i) seq4_lut[i] = 15;
    for (int i = 0; i < 16; ++i) {
        seq4_lut[(uint8_t)code[i]] = (uint8_t)i;
        seq4_lut[(uint8_t)(code[i] | 0x20)] = (uint8_t)i;  // lowercase
    }
    (void)SEQ4;
    tables_ready = true;
}

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
    const uint32_t* cig, const int64_t* cig_off,
    const uint8_t* seq, const int64_t* seq_off,
    const uint8_t* qual, const uint8_t* no_qual,
    const uint8_t* tags, const int64_t* tag_off,
    uint8_t* out, int64_t out_cap) {
    if (!tables_ready) init_tables();
    uint8_t* p = out;
    uint8_t* lim = out + out_cap;
    for (int64_t i = 0; i < n; ++i) {
        int64_t name_len = name_off[i + 1] - name_off[i] + 1;  // + NUL
        int64_t n_cig = cig_off[i + 1] - cig_off[i];
        int64_t l_seq = seq_off[i + 1] - seq_off[i];
        int64_t seq4_len = (l_seq + 1) / 2;
        int64_t tag_len = tag_off[i + 1] - tag_off[i];
        int64_t body = 32 + name_len + 4 * n_cig + seq4_len + l_seq
                       + tag_len;
        if (p + 4 + body > lim) return -1;

        auto put_i32 = [&](int32_t v) { std::memcpy(p, &v, 4); p += 4; };
        auto put_u16 = [&](uint16_t v) { std::memcpy(p, &v, 2); p += 2; };
        put_i32((int32_t)body);
        put_i32(ref_id[i]);
        put_i32(pos[i]);
        *p++ = (uint8_t)name_len;
        *p++ = (uint8_t)mapq[i];
        put_u16((uint16_t)reg2bin(pos[i], end[i]));
        put_u16((uint16_t)n_cig);
        put_u16((uint16_t)flag[i]);
        put_i32((int32_t)l_seq);
        put_i32(-1);   // ref_id2
        put_i32(-1);   // pos2
        put_i32(0);    // tlen
        std::memcpy(p, names + name_off[i], name_len - 1);
        p += name_len - 1;
        *p++ = 0;
        std::memcpy(p, cig + cig_off[i], 4 * n_cig);
        p += 4 * n_cig;
        const uint8_t* s = seq + seq_off[i];
        for (int64_t j = 0; j + 1 < l_seq; j += 2)
            *p++ = (uint8_t)((seq4_lut[s[j]] << 4) | seq4_lut[s[j + 1]]);
        if (l_seq & 1) *p++ = (uint8_t)(seq4_lut[s[l_seq - 1]] << 4);
        if (no_qual[i]) {
            std::memset(p, 0xFF, l_seq);
            p += l_seq;
        } else {
            const uint8_t* q = qual + seq_off[i];
            for (int64_t j = 0; j < l_seq; ++j) *p++ = (uint8_t)(q[j] - 33);
        }
        std::memcpy(p, tags + tag_off[i], tag_len);
        p += tag_len;
    }
    return p - out;
}

}  // extern "C"

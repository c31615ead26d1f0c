// Memory-bounded SA-IS with a packed 40-bit suffix array.
//
// Role of the reference's large-genome BWT builder
// (reference: libs/ma/src/container/bwt_large.cpp:1522,1607 — incremental
// BWT merge so GRCh38-scale genomes build within RAM). Here the same goal
// is met by running SA-IS (nong/zhang/chan induced sorting, same family as
// the reference's is.cpp) over a 5-byte-per-entry suffix array: for a
// 3.1 Gbp genome (FMD text n = 6.2e9) the SA costs 31 GB instead of 50 GB
// int64, and all recursion workspace lives INSIDE the SA buffer, so peak
// RSS is ~ text + 5n + n/4 bits ≈ 40 GB.
//
// A second entry point streams the BWT (2-bit words + occ checkpoints) and
// the sampled SA straight out of the packed array, so no int64 SA or uint8
// BWT is ever materialized on the Python side.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o _sais40.so sais40.cpp
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint64_t EMPTY = (1ULL << 40) - 1;

// packed 40-bit little-endian array view
struct A40 {
    uint8_t* base;
    inline uint64_t get(uint64_t i) const {
        uint64_t v;
        std::memcpy(&v, base + 5 * i, 8);  // over-read 3 bytes (buffer padded)
        return v & EMPTY;
    }
    inline void set(uint64_t i, uint64_t v) const {
        uint8_t* p = base + 5 * i;
        p[0] = (uint8_t)v;
        p[1] = (uint8_t)(v >> 8);
        p[2] = (uint8_t)(v >> 16);
        p[3] = (uint8_t)(v >> 24);
        p[4] = (uint8_t)(v >> 32);
    }
};

struct Bits {
    std::vector<uint64_t> w;
    explicit Bits(uint64_t n) : w((n + 63) / 64, 0) {}
    inline bool get(uint64_t i) const { return (w[i >> 6] >> (i & 63)) & 1; }
    inline void set(uint64_t i, bool v) {
        if (v) w[i >> 6] |= 1ULL << (i & 63);
        else w[i >> 6] &= ~(1ULL << (i & 63));
    }
};

// text accessors ------------------------------------------------------------
struct TextU8 {  // level 0: codes 0..K-2 plus virtual sentinel 0 at i == n-1
    const uint8_t* s;
    uint64_t n;
    inline uint64_t get(uint64_t i) const { return i + 1 == n ? 0 : (uint64_t)s[i] + 1; }
};

struct Text40 {  // recursion levels: packed ints, explicit sentinel included
    A40 a;
    inline uint64_t get(uint64_t i) const { return a.get(i); }
};

template <class Text>
void sais_rec(const Text& T, A40 SA, uint64_t N, uint64_t K) {
    // N includes the sentinel (T.get(N-1) == 0, unique smallest)
    Bits S(N);
    S.set(N - 1, true);
    for (uint64_t i = N - 1; i-- > 0;) {
        uint64_t a = T.get(i), b = T.get(i + 1);
        S.set(i, a < b || (a == b && S.get(i + 1)));
    }
    auto is_lms = [&](uint64_t i) { return i > 0 && S.get(i) && !S.get(i - 1); };

    // bucket counts as packed 40-bit (K can reach ~N/2 at recursion
    // levels); per-frame allocation — freed before the deepest memory peak
    std::vector<uint8_t> bktbuf(5 * (2 * K) + 8);
    A40 cnt{bktbuf.data()};
    A40 wrk{bktbuf.data() + 5 * K};
    for (uint64_t c = 0; c < K; c++) cnt.set(c, 0);
    for (uint64_t i = 0; i < N; i++) cnt.set(T.get(i), cnt.get(T.get(i)) + 1);

    auto heads = [&] {
        uint64_t sum = 0;
        for (uint64_t c = 0; c < K; c++) { wrk.set(c, sum); sum += cnt.get(c); }
    };
    auto tails = [&] {
        uint64_t sum = 0;
        for (uint64_t c = 0; c < K; c++) { sum += cnt.get(c); wrk.set(c, sum); }
    };
    auto induce = [&] {
        heads();
        for (uint64_t i = 0; i < N; i++) {
            uint64_t j = SA.get(i);
            if (j != EMPTY && j != 0 && !S.get(j - 1)) {
                uint64_t c = T.get(j - 1);
                SA.set(wrk.get(c), j - 1);
                wrk.set(c, wrk.get(c) + 1);
            }
        }
        tails();
        for (uint64_t i = N; i-- > 0;) {
            uint64_t j = SA.get(i);
            if (j != EMPTY && j != 0 && S.get(j - 1)) {
                uint64_t c = T.get(j - 1);
                wrk.set(c, wrk.get(c) - 1);
                SA.set(wrk.get(c), j - 1);
            }
        }
    };

    // ---- stage 1: sort LMS substrings
    for (uint64_t i = 0; i < N; i++) SA.set(i, EMPTY);
    tails();
    for (uint64_t i = 1; i < N; i++)
        if (is_lms(i)) {
            uint64_t c = T.get(i);
            wrk.set(c, wrk.get(c) - 1);
            SA.set(wrk.get(c), i);
        }
    induce();

    // compact sorted LMS positions to the front
    uint64_t n1 = 0;
    for (uint64_t i = 0; i < N; i++) {
        uint64_t j = SA.get(i);
        if (j != EMPTY && is_lms(j)) SA.set(n1++, j);
    }
    // name LMS substrings into SA[n1 + pos/2]
    for (uint64_t i = n1; i < N; i++) SA.set(i, EMPTY);
    uint64_t names = 0, prev = EMPTY;
    for (uint64_t i = 0; i < n1; i++) {
        uint64_t pos = SA.get(i);
        bool diff = false;
        if (prev == EMPTY) diff = true;
        else {
            for (uint64_t d = 0;; d++) {
                if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) {
                    diff = !(is_lms(pos + d) && is_lms(prev + d));
                    break;
                }
                if (T.get(pos + d) != T.get(prev + d)) { diff = true; break; }
            }
        }
        if (diff) { names++; prev = pos; }
        SA.set(n1 + pos / 2, names - 1);
    }
    // compact names (text order) to the tail -> reduced string s1
    uint64_t w = N;
    for (uint64_t i = N; i-- > n1;) {
        uint64_t v = SA.get(i);
        if (v != EMPTY) SA.set(--w, v);
    }
    // s1 lives at SA[N - n1 .. N)
    if (names < n1) {
        A40 s1{SA.base + 5 * (N - n1)};
        A40 SA1{SA.base};
        sais_rec(Text40{s1}, SA1, n1, names);
    } else {
        for (uint64_t i = 0; i < n1; i++) SA.set(SA.get(N - n1 + i), i);
    }
    // map SA1 entries back to LMS text positions: p1 at SA[N - n1 .. N)
    {
        uint64_t j = N - n1;
        for (uint64_t i = 1; i < N; i++)
            if (is_lms(i)) SA.set(j++, i);
    }
    for (uint64_t i = 0; i < n1; i++) SA.set(i, SA.get(N - n1 + SA.get(i)));

    // ---- stage 2: induce from sorted LMS
    for (uint64_t i = n1; i < N; i++) SA.set(i, EMPTY);
    tails();
    for (uint64_t i = n1; i-- > 0;) {
        uint64_t j = SA.get(i);
        SA.set(i, EMPTY);
        uint64_t c = T.get(j);
        wrk.set(c, wrk.get(c) - 1);
        SA.set(wrk.get(c), j);
    }
    induce();
}

}  // namespace

extern "C" {

// SA of s (uint8 codes, any values < 250) + virtual sentinel: fills
// sa40[5*(n+1)+3] packed little-endian. Returns 0 on success.
int sais40_u8(const uint8_t* s, int64_t n, uint8_t* sa40) {
    if (n < 0) return 1;
    uint64_t N = (uint64_t)n + 1;
    if (N >= EMPTY) return 2;
    uint64_t K = 2;  // sentinel + chars
    for (int64_t i = 0; i < n; i++)
        if ((uint64_t)s[i] + 2 > K) K = (uint64_t)s[i] + 2;
    sais_rec(TextU8{s, N}, A40{sa40}, N, K);
    return 0;
}

// Stream the FMD artifacts straight from the packed SA:
//  bwt_words  uint32[nb * wpb]  (2-bit crumbs, 128 bases/block, no $ row)
//  occ_cp     int64[nb * 4]     (counts before each block)
//  ssa        int64[n/ssa_int + 1]  (ssa[0] = -1)
// Returns the primary row (SA row of suffix 0), or -1 on error.
int64_t fmd_from_sa40(const uint8_t* text, int64_t n, const uint8_t* sa40,
                      uint32_t* bwt_words, int64_t* occ_cp, int64_t* ssa,
                      int64_t ssa_int) {
    const int64_t OCC = 128, WPB = 8;
    A40 sa{const_cast<uint8_t*>(sa40)};
    int64_t primary = -1;
    int64_t nb = (n + OCC - 1) / OCC;
    std::memset(bwt_words, 0, sizeof(uint32_t) * (size_t)nb * WPB);
    int64_t counts[4] = {0, 0, 0, 0};
    int64_t out = 0;  // stored BWT index (skips the $ row)
    for (int64_t row = 0; row <= n; row++) {
        uint64_t v = sa.get((uint64_t)row);
        if (row % ssa_int == 0 && row / ssa_int <= n / ssa_int)
            ssa[row / ssa_int] = (int64_t)v;
        if (v == 0) { primary = row; continue; }
        uint8_t c = text[v - 1];
        int64_t b = out / OCC, off = out % OCC;
        if (off == 0)
            for (int k = 0; k < 4; k++) occ_cp[b * 4 + k] = counts[k];
        bwt_words[b * WPB + off / 16] |=
            (uint32_t)(c & 3) << (2 * (off % 16));
        counts[c & 3]++;
        out++;
    }
    ssa[0] = -1;
    return primary;
}

}  // extern "C"

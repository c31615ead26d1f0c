// SA-IS suffix-array construction (linear time, induced sorting).
//
// Native replacement for the numpy prefix-doubling fallback in
// ma_tpu_torch/index/suffix_array.py — the role of the reference's SA builders
// (reference: libs/ma/src/container/is.cpp SA-IS from BWA, and the
// incremental large-genome builder bwt_large.cpp). Exposed to Python via
// ctypes (no pybind11 in this environment).
//
// Build: g++ -O3 -shared -fPIC -o _sais.so sais.cpp
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// generic SA-IS over an integer string s[0..n-1]; s[n-1] must be the unique
// smallest character (sentinel 0). K = alphabet size.
template <typename CharT>
void sais_core(const CharT* s, int64_t* sa, int64_t n, int64_t K) {
    if (n == 1) { sa[0] = 0; return; }
    if (n == 2) { sa[0] = 1; sa[1] = 0; return; }

    std::vector<bool> is_s(n);  // S-type?
    is_s[n - 1] = true;
    is_s[n - 2] = false;
    for (int64_t i = n - 3; i >= 0; i--)
        is_s[i] = s[i] < s[i + 1] || (s[i] == s[i + 1] && is_s[i + 1]);

    auto is_lms = [&](int64_t i) { return i > 0 && is_s[i] && !is_s[i - 1]; };

    std::vector<int64_t> bkt(K), bkt_end(K), bkt_start(K);
    for (int64_t i = 0; i < K; i++) bkt[i] = 0;
    for (int64_t i = 0; i < n; i++) bkt[(int64_t)s[i]]++;
    {
        int64_t sum = 0;
        for (int64_t i = 0; i < K; i++) {
            bkt_start[i] = sum;
            sum += bkt[i];
            bkt_end[i] = sum;
        }
    }

    auto induce = [&](const std::vector<int64_t>& lms) {
        for (int64_t i = 0; i < n; i++) sa[i] = -1;
        // place LMS suffixes at bucket ends (in given order, backwards)
        std::vector<int64_t> tail(bkt_end);
        for (int64_t i = (int64_t)lms.size() - 1; i >= 0; i--) {
            int64_t j = lms[i];
            sa[--tail[(int64_t)s[j]]] = j;
        }
        // induce L from left to right
        std::vector<int64_t> head(bkt_start);
        for (int64_t i = 0; i < n; i++) {
            int64_t j = sa[i];
            if (j > 0 && !is_s[j - 1]) sa[head[(int64_t)s[j - 1]]++] = j - 1;
        }
        // induce S from right to left
        tail = bkt_end;
        for (int64_t i = n - 1; i >= 0; i--) {
            int64_t j = sa[i];
            if (j > 0 && is_s[j - 1]) sa[--tail[(int64_t)s[j - 1]]] = j - 1;
        }
    };

    // 1st pass: LMS positions in text order
    std::vector<int64_t> lms;
    lms.reserve(n / 2 + 1);
    for (int64_t i = 0; i < n; i++)
        if (is_lms(i)) lms.push_back(i);
    induce(lms);

    // name LMS substrings by their sorted order
    int64_t n_lms = (int64_t)lms.size();
    std::vector<int64_t> name_of(n, -1);
    int64_t names = 0;
    int64_t prev = -1;
    for (int64_t i = 0; i < n; i++) {
        int64_t j = sa[i];
        if (j < 0 || !is_lms(j)) continue;
        if (prev >= 0) {
            // compare LMS substrings at prev and j
            int64_t a = prev, b = j;
            bool same = true;
            while (true) {
                if (s[a] != s[b] || is_s[a] != is_s[b]) { same = false; break; }
                a++; b++;
                bool ea = is_lms(a), eb = is_lms(b);
                if (ea || eb) { same = same && ea && eb; break; }
            }
            if (!same) names++;
        }
        name_of[j] = names;
        prev = j;
    }
    names++;

    // order of LMS suffixes
    std::vector<int64_t> order(n_lms);
    if (names < n_lms) {
        std::vector<int64_t> s1(n_lms);
        for (int64_t i = 0; i < n_lms; i++) s1[i] = name_of[lms[i]];
        std::vector<int64_t> sa1(n_lms);
        sais_core(s1.data(), sa1.data(), n_lms, names);
        for (int64_t i = 0; i < n_lms; i++) order[i] = lms[sa1[i]];
    } else {
        // names unique: sorted order is the induced order already
        int64_t c = 0;
        std::vector<int64_t> tmp(n_lms);
        for (int64_t i = 0; i < n; i++)
            if (sa[i] >= 0 && is_lms(sa[i])) tmp[c++] = sa[i];
        order = tmp;
    }

    induce(order);
}

}  // namespace

extern "C" {

// codes: values 0..254 (our bases 0..4); writes SA of (codes + sentinel)
// into sa[0..n], where the sentinel suffix (index n) lands at sa[0].
int sais_u8(const uint8_t* codes, int64_t n, int64_t* sa) {
    if (n < 0) return -1;
    std::vector<uint8_t> s(n + 1);
    for (int64_t i = 0; i < n; i++) s[i] = (uint8_t)(codes[i] + 1);
    s[n] = 0;  // sentinel
    sais_core(s.data(), sa, n + 1, 256);
    return 0;
}

}  // extern "C"

// Honest single-core CPU baseline for the stream+Bloom pass.
//
// A minimal, fast C++ implementation of the reference's phase-1/phase-2
// hot loops (SURVEY.md §3.1-3.2, §A.2-A.3): getline reader, rolling
// 2-bit canonical k-mers, two blocked Bloom filters wired as the A->B
// cascade, then a scan pass with the 8-way extension junction probe
// (early-exit like a CPU implementation would). This is what bench.py's
// `vs_baseline` divides by — the same WORK the device pass does, written
// the way a performance-minded C++ author would write it for one core.
//
// Differences from the real Faucet (documented, favoring the BASELINE):
//  - dense scan probes every solid window; the reference's junction-to-
//    junction distance hops skip linear stretches (fewer probes) but
//    also do per-position hash-map lookups and branchy bookkeeping.
//  - junction bookkeeping here is a bare unordered_map bump (cheaper
//    than the reference's per-slot cov/dist updates).
//
// Build: g++ -O3 -march=native -o cpu_ref cpu_ref.cc
// Usage: cpu_ref <reads.txt> <k> <log2_a_bits> <log2_b_bits> <nha> <nhb>
//   reads.txt: one ACGT read per line. Prints one JSON line to stdout.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <chrono>
#include <string>
#include <unordered_map>
#include <vector>

static inline uint32_t fmix32(uint32_t x) {
  x ^= x >> 16; x *= 0x85EBCA6Bu; x ^= x >> 13; x *= 0xC2B2AE35u;
  x ^= x >> 16; return x;
}

struct Hash2 { uint32_t h1, h2; };
static inline Hash2 hash_pair(uint64_t code) {
  uint32_t hi = (uint32_t)(code >> 32), lo = (uint32_t)code;
  Hash2 h;
  h.h1 = fmix32(lo ^ fmix32(hi ^ 0x9E3779B9u));
  h.h2 = fmix32(hi ^ fmix32(lo ^ 0x85EBCA77u)) | 1u;
  return h;
}

// 512-bit (cache-line) blocked Bloom: one memory access per probe/insert.
struct Bloom {
  std::vector<uint64_t> w;  // 8 x u64 per block
  uint32_t block_mask;
  int nh;
  Bloom(int log2_bits, int n_hash) : nh(n_hash) {
    size_t words = ((size_t)1 << log2_bits) / 64;
    w.assign(words, 0);
    block_mask = (uint32_t)(words / 8 - 1);
  }
  static inline uint32_t rot16(uint32_t x) { return (x >> 16) | (x << 16); }
  inline bool contains(Hash2 h) const {
    const uint64_t* blk = &w[(size_t)(h.h1 & block_mask) * 8];
    uint32_t h1r = rot16(h.h1);
    for (int j = 1; j <= nh; j++) {
      uint32_t bit = (h1r + (uint32_t)j * h.h2) & 511u;
      if (!((blk[bit >> 6] >> (bit & 63u)) & 1u)) return false;
    }
    return true;
  }
  inline void add(Hash2 h) {
    uint64_t* blk = &w[(size_t)(h.h1 & block_mask) * 8];
    uint32_t h1r = rot16(h.h1);
    for (int j = 1; j <= nh; j++) {
      uint32_t bit = (h1r + (uint32_t)j * h.h2) & 511u;
      blk[bit >> 6] |= 1ull << (bit & 63u);
    }
  }
};

static int8_t NT[256];

int main(int argc, char** argv) {
  if (argc != 7) {
    fprintf(stderr, "usage: %s reads.txt k log2_a log2_b nha nhb\n",
            argv[0]);
    return 2;
  }
  const char* path = argv[1];
  int k = atoi(argv[2]);
  int la = atoi(argv[3]), lb = atoi(argv[4]);
  int nha = atoi(argv[5]), nhb = atoi(argv[6]);
  memset(NT, -1, sizeof NT);
  NT['A'] = 0; NT['C'] = 1; NT['T'] = 2; NT['G'] = 3;
  NT['a'] = 0; NT['c'] = 1; NT['t'] = 2; NT['g'] = 3;

  // read everything up front (bench.py synthesizes reads on the device;
  // IO is excluded there, so exclude it here too)
  std::vector<std::string> reads;
  {
    FILE* f = fopen(path, "r");
    if (!f) { perror("open"); return 2; }
    char* line = nullptr; size_t cap = 0; ssize_t n;
    while ((n = getline(&line, &cap, f)) > 0) {
      while (n > 0 && (line[n-1] == '\n' || line[n-1] == '\r')) n--;
      if (n >= k) reads.emplace_back(line, (size_t)n);
    }
    free(line); fclose(f);
  }

  Bloom A(la, nha), B(lb, nhb);
  const uint64_t kmask = (k == 32) ? ~0ull : ((1ull << (2 * k)) - 1);
  const int shift_rc = 2 * (k - 1);

  auto t0 = std::chrono::steady_clock::now();
  // ---- phase 1: cascade load -------------------------------------------
  for (const auto& r : reads) {
    uint64_t fwd = 0, rc = 0; int run = 0;
    for (size_t i = 0; i < r.size(); i++) {
      int8_t c = NT[(uint8_t)r[i]];
      if (c < 0) { run = 0; fwd = rc = 0; continue; }
      fwd = ((fwd << 2) | (uint64_t)c) & kmask;
      rc = (rc >> 2) | ((uint64_t)(c ^ 2) << shift_rc);
      if (++run < k) continue;
      uint64_t canon = fwd < rc ? fwd : rc;
      Hash2 h = hash_pair(canon);
      if (A.contains(h)) B.add(h); else A.add(h);
    }
  }
  auto t1 = std::chrono::steady_clock::now();

  // ---- phase 2: scan (8-way extension junction probe) -------------------
  std::unordered_map<uint64_t, uint32_t> junc;
  uint64_t solid_windows = 0, junc_hits = 0;
  for (const auto& r : reads) {
    uint64_t fwd = 0, rc = 0; int run = 0;
    for (size_t i = 0; i < r.size(); i++) {
      int8_t c = NT[(uint8_t)r[i]];
      if (c < 0) { run = 0; fwd = rc = 0; continue; }
      fwd = ((fwd << 2) | (uint64_t)c) & kmask;
      rc = (rc >> 2) | ((uint64_t)(c ^ 2) << shift_rc);
      if (++run < k) continue;
      uint64_t canon = fwd < rc ? fwd : rc;
      if (!B.contains(hash_pair(canon))) continue;
      solid_windows++;
      int right = 0;
      for (uint64_t e = 0; e < 4 && right < 2; e++) {
        uint64_t f2 = ((fwd << 2) | e) & kmask;
        uint64_t r2 = (rc >> 2) | ((e ^ 2) << shift_rc);
        if (B.contains(hash_pair(f2 < r2 ? f2 : r2))) right++;
      }
      bool isj = right >= 2;
      if (!isj) {
        int left = 0;
        for (uint64_t e = 0; e < 4 && left < 2; e++) {
          uint64_t f2 = (fwd >> 2) | (e << shift_rc);
          uint64_t r2 = ((rc << 2) | (e ^ 2)) & kmask;
          if (B.contains(hash_pair(f2 < r2 ? f2 : r2))) left++;
        }
        isj = left >= 2;
      }
      if (isj) { junc_hits++; junc[canon]++; }
    }
  }
  auto t2 = std::chrono::steady_clock::now();

  double load_s = std::chrono::duration<double>(t1 - t0).count();
  double scan_s = std::chrono::duration<double>(t2 - t1).count();
  double total = load_s + scan_s;
  printf("{\"reads\": %zu, \"load_s\": %.4f, \"scan_s\": %.4f, "
         "\"reads_per_s\": %.1f, \"solid_windows\": %llu, "
         "\"junction_hits\": %llu, \"distinct_junctions\": %zu}\n",
         reads.size(), load_s, scan_s, reads.size() / total,
         (unsigned long long)solid_windows,
         (unsigned long long)junc_hits, junc.size());
  return 0;
}

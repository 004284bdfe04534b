// The port's native point-cloud reader: read + crop + resample of the
// training binaries on host threads, with a plain C interface loaded through
// ctypes (feat3dnet_tpu_torch/utils/native.py builds it with g++ at first use).
//
//   * .bin files are float32 rows of num_cols (XYZ first);
//   * crop: keep rows with x^2 + y^2 + z^2 <= crop_radius^2 (every row when
//     crop_radius <= 0);
//   * resample to exactly num_points: the first num_points of a partial
//     Fisher-Yates shuffle when enough rows survive, else every row in order
//     and then uniform draws with replacement. The generator is xoshiro256**
//     seeded per cloud through splitmix64, drawing below n by Lemire's method.
//
// Its batches equal the JAX package's native reader (native/pointcloud_io.cpp)
// bit for bit: the same generator, the same draws, the same crop arithmetic.
// f3d_load_processed_batch reads its files on a pool of threads outside the
// Python interpreter's lock.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Xoshiro256 {
  uint64_t s[4];
  explicit Xoshiro256(uint64_t seed) {
    // splitmix64 init
    for (int i = 0; i < 4; i++) {
      seed += 0x9E3779B97f4A7C15ULL;
      uint64_t z = seed;
      z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
      z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
      s[i] = z ^ (z >> 31);
    }
  }
  static uint64_t rotl(uint64_t x, int k) { return (x << k) | (x >> (64 - k)); }
  uint64_t next() {
    uint64_t result = rotl(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0]; s[3] ^= s[1]; s[1] ^= s[2]; s[0] ^= s[3]; s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  // uniform integer in [0, n) without modulo bias (Lemire)
  uint64_t below(uint64_t n) {
    __uint128_t m = ( (__uint128_t)next() ) * n;
    uint64_t l = (uint64_t)m;
    if (l < n) {
      uint64_t t = (-n) % n;
      while (l < t) { m = ((__uint128_t)next()) * n; l = (uint64_t)m; }
    }
    return (uint64_t)(m >> 64);
  }
};

// Read whole file into buf; returns row count or -1.
long read_rows(const char* path, int num_cols, std::vector<float>& buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long bytes = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (bytes < 0 || bytes % (long)(sizeof(float) * num_cols) != 0) {
    std::fclose(f);
    return -1;
  }
  buf.resize(bytes / sizeof(float));
  size_t got = std::fread(buf.data(), 1, (size_t)bytes, f);
  std::fclose(f);
  if (got != (size_t)bytes) return -1;
  return bytes / (long)(sizeof(float) * num_cols);
}

int load_one(const char* path, int num_cols, float crop_radius, int num_points,
             uint64_t seed, float* out) {
  std::vector<float> buf;
  long rows = read_rows(path, num_cols, buf);
  if (rows <= 0) return -1;

  // Crop: collect surviving row indices.
  const float r2 = crop_radius * crop_radius;
  std::vector<int64_t> keep;
  keep.reserve((size_t)rows);
  for (long i = 0; i < rows; i++) {
    const float* p = &buf[(size_t)i * num_cols];
    // fma(p2, p2, fma(p1, p1, p0 * p0)): what g++ -O3 -march=native makes of
    // p0*p0 + p1*p1 + p2*p2 on an x86 with FMA, written out so that a point on
    // the crop boundary falls on the same side whatever the compiler contracts
    const float d2 = std::fmaf(p[2], p[2], std::fmaf(p[1], p[1], p[0] * p[0]));
    if (crop_radius <= 0.0f || d2 <= r2) keep.push_back(i);
  }
  const int64_t n = (int64_t)keep.size();
  if (n == 0) return -2;

  Xoshiro256 rng(seed);
  auto emit = [&](int64_t src_row, int64_t dst_row) {
    std::memcpy(out + (size_t)dst_row * num_cols,
                &buf[(size_t)keep[(size_t)src_row] * num_cols],
                sizeof(float) * (size_t)num_cols);
  };

  if (n <= num_points) {
    for (int64_t i = 0; i < n; i++) emit(i, i);
    for (int64_t i = n; i < num_points; i++) emit((int64_t)rng.below((uint64_t)n), i);
  } else {
    // partial Fisher-Yates: first num_points of a random permutation
    for (int64_t i = 0; i < num_points; i++) {
      int64_t j = i + (int64_t)rng.below((uint64_t)(n - i));
      std::swap(keep[(size_t)i], keep[(size_t)j]);
      emit(i, i);
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Single file. Returns 0 ok, -1 io/format error, -2 empty after crop.
int f3d_load_processed(const char* path, int num_cols, float crop_radius,
                       int num_points, uint64_t seed, float* out) {
  return load_one(path, num_cols, crop_radius, num_points, seed, out);
}

// Batch with a thread pool. out is (n, num_points, num_cols) row-major.
// status is length n (per-file result codes). Returns 0 if all succeeded.
int f3d_load_processed_batch(const char** paths, int n, int num_cols,
                             float crop_radius, int num_points,
                             const uint64_t* seeds, float* out, int* status,
                             int num_threads) {
  if (num_threads <= 0) {
    num_threads = (int)std::thread::hardware_concurrency();
    if (num_threads <= 0) num_threads = 1;
  }
  if (num_threads > n) num_threads = n > 0 ? n : 1;
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      int rc = load_one(paths[i], num_cols, crop_radius, num_points, seeds[i],
                        out + (size_t)i * num_points * num_cols);
      status[i] = rc;
      if (rc != 0) failures.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < num_threads; t++) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load() == 0 ? 0 : -1;
}

// Raw whole-file read into caller buffer (capacity = max_rows*num_cols
// floats). Returns row count, or negative on error/overflow.
long f3d_read_cloud(const char* path, int num_cols, float* out, long max_rows) {
  std::vector<float> buf;
  long rows = read_rows(path, num_cols, buf);
  if (rows < 0) return -1;
  if (rows > max_rows) return -2;
  std::memcpy(out, buf.data(), sizeof(float) * (size_t)rows * num_cols);
  return rows;
}

}  // extern "C"

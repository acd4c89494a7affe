// Hand-written Hopper kernels for the attendance sketches: the fused hot
// path, the generic sketch store and the mesh engine.
//
// Twelve kernels (K1 in three forms, K2 in three wire variants), each
// bound through a plain C entry point (ctypes, see ops/build.py and
// ops/kernels.py). Every entry point launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError() so a refused launch
// is reported to the caller.
//
//   K1 atp_hll_histogram  register-value histogram per HLL bank, one CTA
//                         per bank counting into per-thread shared-memory
//                         counters (replaces the Pallas
//                         hll_histogram_pallas,
//                         attendance_tpu/ops/pallas_kernels.py:373-406)
//      atp_hll_histogram_rows  the same over a list of banks, CTA b
//                         counting bank rows[b] (replaces the generic
//                         store's gather + histogram,
//                         attendance_tpu/sketch/tpu_store.py:102-124)
//      atp_hll_union_histogram  histogram of the register max over a list
//                         of banks, a grid over register slices
//                         (replaces HyperLogLog.count_union,
//                         attendance_tpu/models/hll.py:363-372)
//   K2 atp_fused_step     Bloom probe + HLL register max + validity
//                         counters over one frame, word or bytes wire;
//                         each key's 64-byte Bloom block is read once,
//                         by four lanes together, into shared memory
//                         (replaces the XLA programs fused_step_words /
//                         fused_step_bytes, attendance_tpu/models/fused.py)
//      atp_fused_step_seg   the same step over the seg wire in one launch:
//                         each CTA scans the per-bank counts in shared
//                         memory and finds its lanes' banks there
//                         (replaces the XLA program fused_step_seg,
//                         models/fused.py:261)
//      atp_fused_step_delta the same step over the delta wire: a pass of
//                         tile and group delta sums, then the step as its
//                         programmatic dependent, each key its segment's
//                         scan from the sums with no wait between CTAs
//                         (replaces fused_step_delta, :386)
//   K3 atp_bloom_add      packed Bloom preload: a large batch binned by
//                         filter tile and ORed in shared memory (a memset
//                         and three kernels), a small one by one thread
//                         per key with global atomicOr
//                         (replaces bloom_add_packed / packed_or_scatter,
//                         attendance_tpu/models/bloom.py:223-271)
//   K4 atp_bloom_contains blocked BF.EXISTS straight from the packed words
//                         (replaces the Pallas bloom_contains_packed and
//                         bloom_contains_hbm, attendance_tpu/ops/
//                         pallas_kernels.py:197,340, and the XLA probe of
//                         the temporal plane's window add)
//   K5 atp_hll_add        windowed PFADD: masked register max per lane
//                         (replaces the hll_add half of the XLA program
//                         _t_add, attendance_tpu/pipeline/fast_path.py:991)
//   K6 atp_cms_step       Count-Min update, then query, two launches
//                         (replaces the XLA cms_step,
//                         attendance_tpu/models/cms.py:116)
//   K7 atp_bloom_add_bytes  BF.ADD into the byte-per-bit filter, flat or
//                         blocked: one thread per key for a small batch,
//                         else partial packed images set in shared memory,
//                         then one pass ORing them into the filter's bytes
//                         (replaces the XLA bloom_add,
//                         attendance_tpu/models/bloom.py:143)
//   K8 atp_bloom_contains_bytes  BF.EXISTS against it: one thread per key
//                         for a small batch, else a pack pass into a packed
//                         image and a probe of it (in shared memory when
//                         flat, by K4 when blocked)
//                         (replaces the XLA bloom_contains,
//                         attendance_tpu/models/bloom.py:158)
//   K9 atp_bloom_contains_slice  BF.EXISTS against one mesh cell's slice of
//                         the filter, a probe outside it counting as set;
//                         on a slice of under half the filter each CTA
//                         first compacts its in-slice lanes, so fewer
//                         warps probe (replaces local_contains,
//                         attendance_tpu/parallel/sharded.py:304)
//   K10 atp_hll_add_slice K5 on one cell's register slice, with the
//                         replica's counters (replaces hll_add_local and
//                         bump_local, sharded.py:342,359)
//   K11 atp_bloom_add_slice  K3 on one cell's filter slice: the binned
//                         passes over the slice's tiles for a replica's
//                         whole share of the roster, one thread per key
//                         for a small batch (replaces bloom_add_kernel's
//                         scatter, sharded.py:323)
//   K12 atp_decode_seg, atp_decode_delta  a narrow wire's lanes alone, as
//                         key and bank arrays, for the mesh engine's K9
//                         and K10: several lanes a thread, a short header
//                         searched in registers; the delta wire in one
//                         launch with a decoupled look-back, or K2-delta's
//                         two-pass decode where that is faster
//                         (replaces decode_seg_lanes / decode_delta_lanes,
//                         attendance_tpu/models/fused.py:292,416, in
//                         make_step_narrow, parallel/sharded.py:446)
//
// The hash is MurmurHash3_x86_32 of each key's 4 little-endian bytes,
// with the seeds of attendance_tpu_torch/ops/murmur3.py; all arithmetic
// is uint32, so results are bit-identical to the plain PyTorch versions.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;


namespace {

constexpr uint32_t kSeedBloomA = 0x9747B28Cu;
constexpr uint32_t kSeedBloomB = 0x85EBCA6Bu;
constexpr uint32_t kSeedBlock = 0x27D4EB2Fu;
constexpr uint32_t kSeedHllLo = 0xADC83B19u;
constexpr uint32_t kSeedHllHi = 0x2545F491u;
// Count-Min row r hashes with kSeedCmsBase + r * kSeedCmsStep (mod 2^32).
constexpr uint32_t kSeedCmsBase = 0x7F4A7C15u;
constexpr uint32_t kSeedCmsStep = 0x9E3779B9u;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t murmur3_u32(uint32_t key, uint32_t seed) {
  uint32_t k = key * 0xCC9E2D51u;
  k = rotl32(k, 15);
  k *= 0x1B873593u;
  uint32_t h = seed ^ k;
  h = rotl32(h, 13);
  h = h * 5u + 0xE6546B64u;
  h ^= 4u;  // total length in bytes
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// x % d for uint32 x and d >= 1 without a division (Lemire, Kaser and
// Kurz, "Faster remainder by direct computation", 2019): magic is 2^64 / d
// rounded up (mod 2^64), from fastmod_magic on the host. Exact for every
// 32-bit x and d.
__device__ __forceinline__ uint32_t fastmod(uint32_t x, uint64_t magic,
                                            uint32_t d) {
  return static_cast<uint32_t>(__umul64hi(magic * x, d));
}

uint64_t fastmod_magic(uint32_t d) { return ~uint64_t{0} / d + 1; }

// Blocked Bloom probe of one key per lane, called by all 32 lanes of a
// warp together (present = false for a lane with no key). Every probe of
// a key lands in one 512-bit block (16 words) chosen by h1 % num_blocks,
// at offsets (h2 + j*h3) & 511. The four lanes of a quad read one key's
// whole block with one 16-byte load each, so each warp-wide load
// instruction brings in 8 blocks (8 cache lines, where a scalar probe
// touches 32 lines per instruction, k times over); four such loads stage
// the warp's 32 blocks in ``stage`` (128 uint4 of shared memory, the
// warp's own), and each lane tests its k bits there. The wrapper checks
// that the words start 64-byte aligned, so a block is one aligned 64-byte
// segment. warp_bloom_probe_block is the probe of a block index already
// computed (K9 probes a slice, whose first block is not the filter's);
// warp_bloom_probe computes it from the key.
__device__ __forceinline__ bool warp_bloom_probe_block(
    const uint32_t* __restrict__ words, uint32_t block, int k, uint32_t key,
    bool present, uint4* stage) {
  const int lane = static_cast<int>(threadIdx.x & 31);
  const uint4* words4 = reinterpret_cast<const uint4*>(words);
  uint4 quarter[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    // Round r: lanes 4q..4q+3 read the block of lane 8r + q.
    const uint32_t b = __shfl_sync(0xFFFFFFFFu, block, r * 8 + (lane >> 2));
    quarter[r] = __ldg(words4 + static_cast<size_t>(b) * 4u + (lane & 3));
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) stage[r * 32 + lane] = quarter[r];
  __syncwarp();
  const uint32_t* mine = reinterpret_cast<const uint32_t*>(stage) + lane * 16;
  const uint32_t h2 = murmur3_u32(key, kSeedBloomB) | 1u;
  const uint32_t h3 = murmur3_u32(key, kSeedBlock) | 1u;
  bool hit = present;
#pragma unroll 4
  for (int j = 0; j < k; ++j) {
    const uint32_t off = (h2 + static_cast<uint32_t>(j) * h3) & 511u;
    hit &= ((mine[off >> 5] >> (off & 31u)) & 1u) != 0u;
  }
  return hit;
}

__device__ __forceinline__ bool warp_bloom_probe(
    const uint32_t* __restrict__ words, uint32_t num_blocks, uint64_t magic,
    int k, uint32_t key, bool present, uint4* stage) {
  const uint32_t block =
      present ? fastmod(murmur3_u32(key, kSeedBloomA), magic, num_blocks) : 0u;
  return warp_bloom_probe_block(words, block, k, key, present, stage);
}

// Redis dense-HLL (bucket, rank) of a key: bucket = low p bits of h1,
// rank = 1 + count-trailing-zeros of the (64-p)-bit pattern (bits p..31
// of h1, then h2), capped at 65 - p. Shared by K2 and K5.
__device__ __forceinline__ void hll_bucket_rank(uint32_t key, int precision,
                                                uint32_t* bucket,
                                                uint32_t* rank) {
  const uint32_t h1 = murmur3_u32(key, kSeedHllLo);
  const uint32_t h2 = murmur3_u32(key, kSeedHllHi);
  *bucket = h1 & ((1u << precision) - 1u);
  const uint32_t lo = (h1 >> precision) | (h2 << (32 - precision));
  const uint32_t hi = h2 >> precision;
  // __ffs is 1 + count-trailing-zeros (0 for a zero word).
  *rank = lo != 0u ? static_cast<uint32_t>(__ffs(lo))
        : hi != 0u ? 32u + static_cast<uint32_t>(__ffs(hi))
                   : static_cast<uint32_t>(64 - precision + 1);
}

// Byte-wide atomic max: CUDA has no 8-bit atomics, so CAS the aligned
// 32-bit word holding the byte. Register rows are 2^p >= 16 bytes and
// the wrapper checks a 4-byte-aligned base, so the word never straddles
// a row.
__device__ __forceinline__ void atomic_max_u8(uint8_t* addr, uint32_t val) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(addr);
  uint32_t* word = reinterpret_cast<uint32_t*>(a & ~static_cast<uintptr_t>(3));
  const uint32_t shift = static_cast<uint32_t>(a & 3u) * 8u;
  uint32_t old = *reinterpret_cast<volatile uint32_t*>(word);
  while (((old >> shift) & 0xFFu) < val) {
    const uint32_t next = (old & ~(0xFFu << shift)) | (val << shift);
    const uint32_t seen = atomicCAS(word, old, next);
    if (seen == old) break;
    old = seen;
  }
}

// ---------------------------------------------------------------------------
// K1: register-value histogram, one CTA per bank. Values >= num_bins are
// dropped, as jnp.bincount(length=) does.
//
// Every thread owns one 32-bit shared-memory counter per value below 64,
// laid out [value][thread] (64 KB), so all of a thread's counters sit in
// its own shared-memory bank and no two lanes of a warp ever touch one
// address (bins shared by a warp put most of its lanes on the same hot
// bin, as register values are skewed). Each byte is one shared atomicAdd whose result is unused, so
// a thread's adds do not wait on each other (a plain load-add-store
// must: the next byte may hit the same counter). A thread issues all of
// a batch's 16-byte loads before counting any; the first batch is in
// flight while the counters clear. Then a warp per value sums that
// value's row of counters and writes the output. One shared atomic per
// byte bounds it at large bank counts; at small ones, the launch and one
// trip to memory. Measured on an H100 and slower (PERF.md): a bank split
// over a thread-block cluster of 2-8 CTAs (their partial bins summed
// through distributed shared memory), 16-bit packed counters, a
// load-add-store instead of the atomic, SWAR counting in registers, and
// a hot value kept out of the atomics.
// ---------------------------------------------------------------------------
constexpr int kHistRows = 64;  // a counter row for every value < 64
constexpr int kHistVec = 4;    // 16-byte loads a thread issues at once
constexpr size_t kHistSmem = sizeof(uint32_t) * kHistRows * kThreads;

// Loads the batch of vectors v0, v0 + kThreads, ... (zeros past `nvec`).
__device__ __forceinline__ void hist_load(const uint4* __restrict__ row,
                                          int v0, int nvec,
                                          uint4 (&x)[kHistVec]) {
#pragma unroll
  for (int u = 0; u < kHistVec; ++u) {
    const int v = v0 + u * kThreads;
    x[u] = v < nvec ? __ldg(row + v) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// rows == nullptr: CTA b counts bank b (K1). Else CTA b counts bank
// rows[b], clamped into [0, num_banks) as a JAX gather clamps (K1-rows).
__global__ void __launch_bounds__(kThreads)
hll_histogram_kernel(const uint8_t* __restrict__ regs, int m, int num_bins,
                     const int32_t* __restrict__ rows, int num_banks,
                     int32_t* __restrict__ out) {
  extern __shared__ uint4 hist_smem[];
  uint32_t* counts = reinterpret_cast<uint32_t*>(hist_smem);
  const int tid = static_cast<int>(threadIdx.x);
  const int nvec = m / 16;
  const int bank = rows == nullptr
                       ? static_cast<int>(blockIdx.x)
                       : min(max(__ldg(rows + blockIdx.x), 0), num_banks - 1);
  const uint4* row = reinterpret_cast<const uint4*>(
      regs + static_cast<size_t>(bank) * static_cast<size_t>(m));
  uint4 x[kHistVec];
  hist_load(row, tid, nvec, x);  // in flight while the counters clear
  for (int i = tid; i < kHistRows * kThreads / 4; i += kThreads) {
    hist_smem[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  uint32_t* mine = counts + tid;  // value v's counter: mine[v * kThreads]
  for (int v0 = tid;;) {
#pragma unroll
    for (int u = 0; u < kHistVec; ++u) {
      if (v0 + u * kThreads >= nvec) continue;
      const uint32_t w[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
      // Every byte < 64 (the usual case): 16 unconditional atomics. A
      // condition on each atomic, even one that always holds, made the
      // kernel markedly slower on an H100 (PERF.md).
      if (((x[u].x | x[u].y | x[u].z | x[u].w) & 0xC0C0C0C0u) == 0u) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            atomicAdd(mine + ((w[i] >> (8 * b)) & 0xFFu) * kThreads, 1u);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const uint32_t v = (w[i] >> (8 * b)) & 0xFFu;
            if (v < kHistRows) atomicAdd(mine + v * kThreads, 1u);
          }
        }
      }
    }
    v0 += kHistVec * kThreads;
    if (v0 >= nvec) break;
    hist_load(row, v0, nvec, x);
  }
  __syncthreads();
  const int lane = tid & 31;
  int32_t* out_row = out + static_cast<size_t>(blockIdx.x) * num_bins;
  for (int r = tid >> 5; r < num_bins; r += kWarps) {
    const uint32_t* counters = counts + r * kThreads;
    uint32_t s = 0u;
#pragma unroll
    for (int i = lane; i < kThreads; i += 32) s += counters[i];
    s = __reduce_add_sync(0xFFFFFFFFu, s);
    if (lane == 0) out_row[r] = static_cast<int32_t>(s);
  }
}

// ---------------------------------------------------------------------------
// K2: one lane per thread, one pass over a full grid. Decode (key, bank)
// from the wire, probe the Bloom filter warp-wide (warp_bloom_probe), and
// for valid real lanes max the HLL rank into its register. Valid/invalid
// counts are reduced per warp with ballots and per CTA in shared memory,
// then added with one 64-bit atomic per CTA per counter: the uint32[2, 2]
// (lo, hi) counters, read little-endian, are exactly two uint64 totals.
// The decode is the kernel's template parameter, one functor per wire
// (below), called once by every thread of the CTA: it returns the
// thread's lane and, for a lane below `lanes`, decodes (key, bank). The
// probe-and-count tail is the same for all four wires.
// ---------------------------------------------------------------------------

// Exclusive prefix sum over t in [0, count) of in(t) into out[0, count)
// (shared memory), and the total into out[count], by one whole CTA of
// Threads threads; each thread reads its in(t) once.
template <int Threads = kThreads, typename In>
__device__ void cta_exclusive_scan(In in, int count, uint32_t* out) {
  __shared__ uint32_t warp_sums[Threads / 32];
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int warp = static_cast<int>(threadIdx.x >> 5);
  const int per = (count + Threads - 1) / Threads;
  const int lo = min(count, static_cast<int>(threadIdx.x) * per);
  const int hi = min(count, lo + per);
  uint32_t sum = 0u;
  for (int t = lo; t < hi; ++t) {
    out[t] = in(t);
    sum += out[t];
  }
  uint32_t incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  uint32_t base = 0u;
  for (int w = 0; w < warp; ++w) base += warp_sums[w];
  uint32_t run = base + incl - sum;
  for (int t = lo; t < hi; ++t) {
    const uint32_t v = out[t];
    out[t] = run;
    run += v;
  }
  if (threadIdx.x == Threads - 1) out[count] = base + incl;
  __syncthreads();  // out is whole and warp_sums free for the next scan
}

// Word and bytes wires.
// bank_bytes == 0: word wire, uint32[lanes] of bank << key_bits | key,
//                  all-ones bank field = padding.
// bank_bytes in {1, 2, 4}: bytes wire, uint32 keys[lanes] then
//                  uint{8*bank_bytes} banks[lanes], dtype max = padding.
struct WireDecode {
  const uint8_t* wire;
  int bank_bytes;
  int key_bits;
  int lanes;

  __device__ __forceinline__ int operator()(uint32_t* key,
                                            int32_t* bank) const {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i < lanes) lane(i, key, bank);
    return i;
  }

  __device__ __forceinline__ void lane(int i, uint32_t* key,
                                       int32_t* bank) const {
    const uint32_t* w32 = reinterpret_cast<const uint32_t*>(wire);
    if (bank_bytes == 0) {
      const uint32_t w = w32[i];
      *key = w & ((1u << key_bits) - 1u);
      const uint32_t field = w >> key_bits;
      *bank = field == (1u << (32 - key_bits)) - 1u
                  ? -1 : static_cast<int32_t>(field);
      return;
    }
    *key = w32[i];
    const uint8_t* banks = wire + 4 * static_cast<size_t>(lanes);
    uint32_t field;
    uint32_t sentinel;
    if (bank_bytes == 1) {
      field = banks[i];
      sentinel = 0xFFu;
    } else if (bank_bytes == 2) {
      field = reinterpret_cast<const uint16_t*>(banks)[i];
      sentinel = 0xFFFFu;
    } else {
      field = reinterpret_cast<const uint32_t*>(banks)[i];
      sentinel = 0xFFFFFFFFu;
    }
    *bank = field == sentinel ? -1 : static_cast<int32_t>(field);
  }
};

// Lane i's `width`-bit field of a little-endian bitstream of uint32 words
// (1 <= width <= 32), in two steps so that a decode can issue the loads
// early: field_words loads the two words that hold bits i * width on (the
// wire's two guard words follow the last lane's), field_of cuts the field
// with a funnel shift, which ignores the second word when the field starts
// a word.
struct FieldWords {
  uint32_t lo, hi, sh;
};

__device__ __forceinline__ FieldWords field_words(
    const uint32_t* __restrict__ stream, int i, int width) {
  const uint64_t bit = static_cast<uint64_t>(i) * static_cast<uint64_t>(width);
  const size_t w0 = static_cast<size_t>(bit >> 5);
  return {__ldg(stream + w0), __ldg(stream + w0 + 1),
          static_cast<uint32_t>(bit & 31u)};
}

__device__ __forceinline__ uint32_t field_of(FieldWords f, int width) {
  const uint32_t v = __funnelshift_r(f.lo, f.hi, f.sh);
  return width >= 32 ? v : v & ((1u << width) - 1u);
}

// The first bank b in [lo, hi) whose end starts[b + 1] exceeds lane i,
// else hi: an upper bound, so runs of empty banks go to the next non-empty
// one, as searchsorted(side="right") does. starts is the exclusive scan
// of the per-bank counts (shared memory).
__device__ __forceinline__ int32_t upper_bank(const uint32_t* starts, int lo,
                                              int hi, uint32_t i) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (starts[mid + 1] > i) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// The narrow wires' bank decode, by the whole CTA of Threads threads:
// scan the wire's per-bank counts into starts[0..num_banks] (dynamic
// shared memory; starts[num_banks] is the frame's total), then threads 0
// and 32 search the banks of the tile's first and last real lane. Lanes
// are sorted by bank, so the tile's lanes t0 .. t0 + Tile - 1 cover a
// contiguous run of banks, usually one (the main path's frame holds about
// 8,192 lanes a bank), and a lane's own search between the two makes no
// compare when they are equal. Returns (first bank, last bank); (0, 0)
// for a tile with no real lane.
template <int Threads = kThreads, int Tile = kThreads>
__device__ __forceinline__ int2 tile_banks(const uint32_t* __restrict__ counts,
                                           int num_banks, uint32_t t0,
                                           uint32_t* starts) {
  __shared__ int range[2];
  cta_exclusive_scan<Threads>([=](int t) { return __ldg(counts + t); },
                              num_banks, starts);
  const uint32_t total = starts[num_banks];
  if (threadIdx.x == 0 || threadIdx.x == 32) {
    const uint32_t at = threadIdx.x == 0 ? t0 : min(t0 + Tile, total) - 1u;
    range[threadIdx.x >> 5] =
        t0 < total ? upper_bank(starts, 0, num_banks, at) : 0;
  }
  __syncthreads();
  return make_int2(range[0], range[1]);
}

// Seg wire: [counts u32[num_banks] | kb-bit keys | guard], lanes sorted
// by bank. A lane's bank is the segment holding it; a padding lane (at or
// past the counts' total) takes the key its bits hold (0 as packed) and
// bank -1. The key loads are issued before the counts' scan.
struct SegDecode {
  const uint32_t* buf;
  int num_banks;
  int kb;
  int lanes;

  __device__ __forceinline__ int operator()(uint32_t* key,
                                            int32_t* bank) const {
    extern __shared__ uint32_t starts[];
    const uint32_t t0 = blockIdx.x * kThreads;
    const int i = static_cast<int>(t0 + threadIdx.x);
    const uint32_t u = static_cast<uint32_t>(i);
    const bool present = i < lanes;
    FieldWords fw{0u, 0u, 0u};
    if (present) fw = field_words(buf + num_banks, i, kb);  // in flight
    const int2 r = tile_banks(buf, num_banks, t0, starts);
    if (present && u < starts[num_banks]) {
      *bank = upper_bank(starts, r.x, r.y, u);
    }
    if (present) *key = field_of(fw, kb);
    return i;
  }
};

// K2-delta's pass 1: every tile's (256 lanes) delta sum and every group's
// (kGroupTiles tiles, a CTA; a warp sums a tile, a lane 8 of its deltas).
// It lets the step's CTAs start at once (a programmatic dependent launch,
// see DeltaDecode).
constexpr int kGroupTiles = kWarps;

__global__ void __launch_bounds__(kThreads)
delta_sums_kernel(const uint32_t* __restrict__ deltas, int db, int lanes,
                  int tiles, uint32_t* __restrict__ tile_sums,
                  uint32_t* __restrict__ group_sums) {
  asm volatile("griddepcontrol.launch_dependents;");
  __shared__ uint32_t warp_sums[kWarps];
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int warp = static_cast<int>(threadIdx.x >> 5);
  const int tile = static_cast<int>(blockIdx.x) * kGroupTiles + warp;
  FieldWords f[kThreads / 32];
#pragma unroll
  for (int j = 0; j < kThreads / 32; ++j) {
    const int i = tile * kThreads + lane + 32 * j;
    f[j] = tile < tiles && i < lanes ? field_words(deltas, i, db)
                                     : FieldWords{0u, 0u, 0u};
  }
  uint32_t s = 0u;
#pragma unroll
  for (int j = 0; j < kThreads / 32; ++j) s += field_of(f[j], db);
  s = __reduce_add_sync(0xFFFFFFFFu, s);
  if (lane == 0) {
    if (tile < tiles) tile_sums[tile] = s;
    warp_sums[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t g = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) g += warp_sums[w];
    group_sums[blockIdx.x] = g;
  }
}

// Thread k's share of the sum of tile_sums over tiles [lo, hi): the tiles
// up to the first group boundary, the whole groups, the tiles after the
// last boundary; item x goes to thread x % kThreads. Plain (coherent)
// loads: the sums come from pass 1, which may still have been running
// when this grid started.
__device__ __forceinline__ uint32_t tile_range_part(const uint32_t* tile_sums,
                                                    const uint32_t* group_sums,
                                                    int lo, int hi, int k) {
  if (lo >= hi) return 0u;
  const int a = min(hi, (lo + kGroupTiles - 1) / kGroupTiles * kGroupTiles);
  const int g_hi = max(a, hi / kGroupTiles * kGroupTiles);
  const int n_lead = a - lo;
  const int n_groups = (g_hi - a) / kGroupTiles;
  const int n = n_lead + n_groups + hi - g_hi;
  uint32_t sum = 0u;
  for (int x = k; x < n; x += kThreads) {
    sum += x < n_lead ? tile_sums[lo + x]
         : x < n_lead + n_groups
             ? group_sums[a / kGroupTiles + (x - n_lead)]
             : tile_sums[g_hi + (x - n_lead - n_groups)];
  }
  return sum;
}

// Delta wire: [counts | bases u32[num_banks] | db-bit deltas | guard],
// lanes sorted by (bank, key). The JAX decode's key is bases[b] + c[i] -
// c[s - 1], c the frame-wide prefix sum of the deltas (mod 2^32), s the
// segment's start: the deltas' inclusive segmented scan, restarted at
// each segment's first lane (a head), plus the bank's base. A padding
// lane's key is bases[0] + c[i].
//
// The step after pass 1 (delta_sums_kernel), with no wait on another
// CTA: a tile (blockIdx.x) scans its own deltas, segmented and, when it
// holds padding lanes, plain. The lanes before its first head continue
// the segment of lane t0, which starts at s0 < t0; their carry is the
// sum over [s0, t0): the head tile's lanes from s0 on (from the wire),
// then the whole tiles after it (pass 1's sums, whole groups by the
// group sums). A padding lane adds the sum over every earlier tile. Each
// of these is one load per thread, all issued together: at most 255
// lanes, 7 + 7 tiles and tiles / 8 groups (512 at 1,048,576 lanes; a
// thread then takes 2 or 3). Everything before the sums are read (the
// counts' scan, the bank search, the deltas' loads) overlaps pass 1:
// the step is its programmatic dependent and waits (griddepcontrol.wait)
// only there. A single pass with decoupled look-back and a two-launch
// pass without the groups or the overlap were slower on an H100
// (PERF.md).
struct DeltaDecode {
  const uint32_t* buf;
  int num_banks;
  int db;
  int lanes;
  const uint32_t* tile_sums;
  const uint32_t* group_sums;

  __device__ __forceinline__ int operator()(uint32_t* key,
                                            int32_t* bank) const {
    extern __shared__ uint32_t starts[];
    __shared__ uint32_t warp_v[kWarps], warp_f[kWarps], warp_p[kWarps];
    __shared__ uint32_t warp_cs[kWarps], warp_cp[kWarps];
    const int tid = static_cast<int>(threadIdx.x);
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int tile = static_cast<int>(blockIdx.x);
    const uint32_t t0 = static_cast<uint32_t>(tile) * kThreads;
    const int i = static_cast<int>(t0) + tid;
    const uint32_t u = static_cast<uint32_t>(i);
    const bool present = i < lanes;
    const uint32_t* deltas = buf + 2 * num_banks;
    FieldWords fw{0u, 0u, 0u};
    if (present) fw = field_words(deltas, i, db);  // in flight
    const int2 r = tile_banks(buf, num_banks, t0, starts);
    const uint32_t total = starts[num_banks];
    const bool real = present && u < total;
    const int32_t b = real ? upper_bank(starts, r.x, r.y, u) : -1;

    // The carries' loads, once pass 1's sums are visible.
    const uint32_t s0 = t0 < total ? starts[r.x] : total;
    asm volatile("griddepcontrol.wait;" ::: "memory");
    uint32_t carry_seg = 0u;
    if (t0 < total && s0 < t0) {
      const int h = static_cast<int>(s0 >> 8);
      const uint32_t head_end = static_cast<uint32_t>(h + 1) * kThreads;
      if (s0 + static_cast<uint32_t>(tid) < head_end) {
        carry_seg = field_of(
            field_words(deltas, static_cast<int>(s0) + tid, db), db);
      }
      carry_seg += tile_range_part(tile_sums, group_sums, h + 1, tile, tid);
    }
    const uint32_t carry_plain =
        t0 + kThreads > total
            ? tile_range_part(tile_sums, group_sums, 0, tile, tid) : 0u;
    const uint32_t d = present ? field_of(fw, db) : 0u;

    // The tile's scans: v segmented (f: a head at or before the lane
    // within the tile; the first padding lane heads a segment too), p
    // plain.
    bool f = real ? starts[b] == u : present && u == total;
    uint32_t v = d;
    uint32_t p = d;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, v, off);
      const int g = __shfl_up_sync(0xFFFFFFFFu, static_cast<int>(f), off);
      const uint32_t z = __shfl_up_sync(0xFFFFFFFFu, p, off);
      if (lane >= off) {
        if (!f) v += y;
        f = f || g != 0;
        p += z;
      }
    }
    const uint32_t cs = __reduce_add_sync(0xFFFFFFFFu, carry_seg);
    const uint32_t cp = __reduce_add_sync(0xFFFFFFFFu, carry_plain);
    if (lane == 31) {
      warp_v[warp] = v;
      warp_f[warp] = f ? 1u : 0u;
      warp_p[warp] = p;
      warp_cs[warp] = cs;
      warp_cp[warp] = cp;
    }
    __syncthreads();
    uint32_t seg_in = 0u;
    uint32_t plain_in = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      seg_in += warp_cs[w];
      plain_in += warp_cp[w];
      if (w < warp) p += warp_p[w];
    }
    for (int w = warp - 1; w >= 0 && !f; --w) {
      v += warp_v[w];
      f = warp_f[w] != 0u;
    }
    if (real) {
      *key = __ldg(buf + num_banks + b) + v + (f ? 0u : seg_in);
      *bank = b;
    } else if (present) {
      *key = __ldg(buf + num_banks) + plain_in + p;
    }
    return i;
  }
};

// Adds the CTA's lanes with `valid_lane` to counts[0] and those with
// `invalid_lane` to counts[1] (the two-lane counters read as two uint64
// totals): warp ballots, a sum per CTA in shared memory, one 64-bit atomic
// per CTA and counter. Called by every thread of the CTA. Shared by K2 and
// K10.
__device__ __forceinline__ void cta_add_counts(bool valid_lane,
                                               bool invalid_lane,
                                               unsigned long long* counts) {
  __shared__ unsigned int warp_valid[kWarps];
  __shared__ unsigned int warp_invalid[kWarps];
  const unsigned int nv = __popc(__ballot_sync(0xFFFFFFFFu, valid_lane));
  const unsigned int ni = __popc(__ballot_sync(0xFFFFFFFFu, invalid_lane));
  if ((threadIdx.x & 31) == 0) {
    warp_valid[threadIdx.x >> 5] = nv;
    warp_invalid[threadIdx.x >> 5] = ni;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sv = 0, si = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sv += warp_valid[w];
      si += warp_invalid[w];
    }
    if (sv) atomicAdd(counts, sv);
    if (si) atomicAdd(counts + 1, si);
  }
}

template <class Decode>
__global__ void __launch_bounds__(kThreads)
fused_step_kernel(Decode decode, int lanes,
                  const uint32_t* __restrict__ bloom, uint32_t num_blocks,
                  uint64_t magic, int k, uint8_t* regs, int num_banks,
                  int precision, unsigned long long* counts,
                  uint8_t* __restrict__ valid) {
  __shared__ uint4 stage[kWarps * 128];
  uint32_t key = 0u;
  int32_t bank = -1;
  const int i = decode(&key, &bank);
  const bool present = i < lanes;
  const bool hit = warp_bloom_probe(bloom, num_blocks, magic, k, key, present,
                                    stage + (threadIdx.x >> 5) * 128);
  const bool real = bank >= 0;
  if (present) {
    valid[i] = hit ? 1 : 0;
    if (hit && real && bank < num_banks) {
      uint32_t bucket, rank;
      hll_bucket_rank(key, precision, &bucket, &rank);
      atomic_max_u8(regs + (static_cast<size_t>(bank) << precision) + bucket,
                    rank);
    }
  }
  cta_add_counts(hit && real, !hit && real, counts);
}

// K12-delta's two-pass design: K2-delta's decode (DeltaDecode, unchanged)
// alone, after K2-delta's pass 1 (see atp_decode_delta).
template <class Decode>
__global__ void __launch_bounds__(kThreads)
decode_lanes_kernel(Decode decode, int lanes, uint32_t* __restrict__ keys,
                    int32_t* __restrict__ bank) {
  uint32_t key = 0u;
  int32_t b = -1;
  const int i = decode(&key, &b);
  if (i < lanes) {
    keys[i] = key;
    bank[i] = b;
  }
}

// ---------------------------------------------------------------------------
// K12: a narrow wire's lanes alone, keys[i] and bank[i] (-1 on padding, the
// real lanes first, as packed), for the mesh engine: a replica's frame is
// decoded once on each device that holds its cells, and K9 and K10 run on
// the arrays (a decode templated into K9 and K10 decodes it 2 sp times:
// 1.2-1.9x slower a replica on an NVIDIA H100 80GB HBM3 at 700 W,
// PERF.md). Bound: bytes, the wire's header and kb or db bits a lane read
// once, 8 bytes a lane written: about 0.2 us at a (4, 2) replica's 65,536
// lanes, 3 us at 1,048,576. At the mesh's shapes what costs is the chain
// before the first store: the launch, the header's load and search, and
// for K12-delta the carry from the tiles before. So each thread decodes 2
// or 4 consecutive lanes (their fields from at most 3 or 5 words, one bank
// search, 8- or 16-byte stores), a header of up to 32 banks is searched in
// registers (SmallHeader), and K12-delta runs in one launch with a
// decoupled look-back (LookbackCarry) wherever that beats K2-delta's
// two-pass decode (decode_delta_plan, ops/kernels.py). Measured and not
// kept (PERF.md): a single thread-block cluster of up to 16 CTAs exchanging
// tile sums in distributed shared memory (its 16 SMs do all the work), and
// CTAs that re-sum the deltas before their tile (the work grows with a
// bank's length).
// ---------------------------------------------------------------------------

// Lanes i .. i + n - 1 (n <= 4) of a little-endian bitstream of `width`-bit
// fields (1 <= width <= 32): four fields from any bit offset lie in at most
// 5 words, loaded once (through the last present lane's second word only,
// so the wire's guard words cover the tail) and cut with funnel shifts.
// Fields at or past n are undefined.
__device__ __forceinline__ void fields4(const uint32_t* __restrict__ stream,
                                        int i, int width, int n,
                                        uint32_t (&out)[4]) {
  const uint64_t bit = static_cast<uint64_t>(i) * static_cast<uint64_t>(width);
  const uint32_t* p = stream + (bit >> 5);
  const uint32_t sh = static_cast<uint32_t>(bit & 31u);
  const int nw =
      n > 0 ? static_cast<int>(
                  (sh + static_cast<uint32_t>((n - 1) * width)) >> 5) + 2
            : 0;
  uint32_t w[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) w[j] = j < nw ? __ldg(p + j) : 0u;
  const uint32_t mask = width >= 32 ? 0xFFFFFFFFu : (1u << width) - 1u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t b = sh + static_cast<uint32_t>(j * width);  // < 128
    uint32_t lo = w[0];
    uint32_t hi = w[1];
#pragma unroll
    for (int x = 1; x < 4; ++x) {
      if ((b >> 5) == static_cast<uint32_t>(x)) {
        lo = w[x];
        hi = w[x + 1];
      }
    }
    out[j] = __funnelshift_r(lo, hi, b) & mask;
  }
}

// The fields of lanes i0 .. i0 + L - 1, of which the first n are present;
// 0 for the others.
template <int L>
__device__ __forceinline__ void load_fields(const uint32_t* __restrict__ stream,
                                            int i0, int width, int n,
                                            uint32_t (&out)[L]) {
  constexpr int kG = L < 4 ? L : 4;
#pragma unroll
  for (int g = 0; g < L; g += kG) {
    uint32_t f[4];
    fields4(stream, i0 + g, width, max(0, min(kG, n - g)), f);
#pragma unroll
    for (int j = 0; j < kG; ++j) out[g + j] = g + j < n ? f[j] : 0u;
  }
}

// Lane i's bank from the bank b of an earlier real lane of its tile (or
// the tile's first bank): b while i stays below b's end, else the search
// from b + 1 to the tile's last bank hi.
__device__ __forceinline__ int32_t next_bank(const uint32_t* starts, int32_t b,
                                             int hi, uint32_t i) {
  return starts[b + 1] > i ? b : upper_bank(starts, b + 1, hi, i);
}

// The wire's header (per-bank counts, and on the delta wire per-bank
// bases) as the K12 kernels read it. Every method is called by all threads
// of the CTA, with any lane index i (the bank of a lane at or past the
// total is not used).
//
// SmallHeader, at most 32 banks (the mesh's 16): each warp loads the
// counts, a bank a lane, scans them with shuffles and finds a lane's bank
// by a five-step binary search over shuffles; bases likewise, a bank a
// lane. No shared memory and no barrier: the header costs one load and a
// few shuffles, where a CTA-wide scan costs two barriers and a search
// behind a third, on the path of every lane.
struct SmallHeader {
  uint32_t end_, start_, total_, base_;

  template <int T, int Tile>
  __device__ __forceinline__ void init(const uint32_t* __restrict__ counts,
                                       int num_banks, uint32_t, uint32_t*) {
    const int lane = static_cast<int>(threadIdx.x & 31);
    const uint32_t c = lane < num_banks ? __ldg(counts + lane) : 0u;
    uint32_t e = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, e, off);
      if (lane >= off) e += y;
    }
    end_ = e;
    start_ = e - c;
    total_ = __shfl_sync(0xFFFFFFFFu, e, 31);
    base_ = 0u;
  }
  __device__ __forceinline__ uint32_t total() const { return total_; }
  __device__ __forceinline__ int32_t first() const { return 0; }
  // The number of banks that end at or before i (a real lane's bank); a
  // lane's search does not wait on the lane before it.
  __device__ __forceinline__ int32_t bank(uint32_t i, int32_t) const {
    int b = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
      if (__shfl_sync(0xFFFFFFFFu, end_, b + step - 1) <= i) b += step;
    }
    return min(b, 31);
  }
  __device__ __forceinline__ uint32_t start_of(int32_t b) const {
    return __shfl_sync(0xFFFFFFFFu, start_, b);
  }
  __device__ __forceinline__ void load_bases(const uint32_t* __restrict__ bases,
                                             int num_banks) {
    const int lane = static_cast<int>(threadIdx.x & 31);
    base_ = lane < num_banks ? __ldg(bases + lane) : 0u;
  }
  __device__ __forceinline__ uint32_t base_of(int32_t b) const {
    return __shfl_sync(0xFFFFFFFFu, base_, b);
  }
  __device__ __forceinline__ uint32_t base0() const { return base_of(0); }
};

// SharedHeader, any number of banks up to NARROW_MAX_BANKS: the CTA scans
// the counts into shared memory (tile_banks) and each lane walks its
// banks there from one search (next_bank); the tile's first and last
// banks' bases are loaded once, others as a lane meets them.
struct SharedHeader {
  const uint32_t* starts_;
  const uint32_t* bases_;
  int2 r_;
  uint32_t total_, base_x_, base_y_, base0_;

  template <int T, int Tile>
  __device__ __forceinline__ void init(const uint32_t* __restrict__ counts,
                                       int num_banks, uint32_t t0,
                                       uint32_t* starts) {
    r_ = tile_banks<T, Tile>(counts, num_banks, t0, starts);
    starts_ = starts;
    total_ = starts[num_banks];
  }
  __device__ __forceinline__ uint32_t total() const { return total_; }
  __device__ __forceinline__ int32_t first() const { return r_.x; }
  __device__ __forceinline__ int32_t bank(uint32_t i, int32_t hint) const {
    return i < total_ ? next_bank(starts_, hint, r_.y, i) : hint;
  }
  __device__ __forceinline__ uint32_t start_of(int32_t b) const {
    return starts_[b];
  }
  __device__ __forceinline__ void load_bases(const uint32_t* __restrict__ bases,
                                             int) {
    bases_ = bases;
    base_x_ = __ldg(bases + r_.x);
    base_y_ = __ldg(bases + r_.y);
    base0_ = __ldg(bases);
  }
  __device__ __forceinline__ uint32_t base_of(int32_t b) const {
    return b == r_.x ? base_x_ : b == r_.y ? base_y_ : __ldg(bases_ + b);
  }
  __device__ __forceinline__ uint32_t base0() const { return base0_; }
};

// keys[i0 + j] and bank[i0 + j] for the lanes j < L below `lanes` (rem =
// lanes - i0, any int): 16-byte stores (8-byte at L = 2) when all L are.
// (rem is tested as it comes: a count clamped to [0, L] and compared
// with L was compiled by nvcc 12.9 into a vector store for every count.)
template <int L>
__device__ __forceinline__ void store_lanes(uint32_t* __restrict__ keys,
                                            int32_t* __restrict__ bank,
                                            int i0, int rem,
                                            const uint32_t (&k)[L],
                                            const int32_t (&b)[L]) {
  if (rem >= L) {
    if constexpr (L == 2) {
      *reinterpret_cast<uint2*>(keys + i0) = make_uint2(k[0], k[1]);
      *reinterpret_cast<int2*>(bank + i0) = make_int2(b[0], b[1]);
    } else {
#pragma unroll
      for (int g = 0; g < L; g += 4) {
        *reinterpret_cast<uint4*>(keys + i0 + g) =
            make_uint4(k[g], k[g + 1], k[g + 2], k[g + 3]);
        *reinterpret_cast<int4*>(bank + i0 + g) =
            make_int4(b[g], b[g + 1], b[g + 2], b[g + 3]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (j < rem) {
        keys[i0 + j] = k[j];
        bank[i0 + j] = b[j];
      }
    }
  }
}

// K12-seg: one launch of CTAs of T threads, L lanes a thread. Each thread
// issues its lanes' word loads, reads the header (Header) and walks its
// lanes' banks from one search. A padding lane keeps the key its bits hold
// and bank -1.
template <int T, int L, class Header>
__global__ void __launch_bounds__(T)
decode_seg_kernel(const uint32_t* __restrict__ buf, int num_banks, int kb,
                  int lanes, uint32_t* __restrict__ keys,
                  int32_t* __restrict__ bank) {
  extern __shared__ uint32_t starts[];
  constexpr int kTile = T * L;
  const uint32_t t0 = blockIdx.x * static_cast<uint32_t>(kTile);
  const int i0 = static_cast<int>(t0) + static_cast<int>(threadIdx.x) * L;
  const int n = max(0, min(L, lanes - i0));
  uint32_t k[L];
  load_fields<L>(buf + num_banks, i0, kb, n, k);  // in flight
  Header hdr;
  hdr.template init<T, kTile>(buf, num_banks, t0, starts);
  const uint32_t total = hdr.total();
  int32_t b[L];
  int32_t cur = hdr.first();
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint32_t i = static_cast<uint32_t>(i0 + j);
    cur = hdr.bank(i, cur);
    b[j] = j < n && i < total ? cur : -1;
  }
  store_lanes<L>(keys, bank, i0, lanes - i0, k, b);
}

// K12-delta's scan element: v the delta sum since the last head (a
// bank's first lane) of a run of lanes, f whether the run holds a head,
// p its plain delta sum. a before b: a + b = (b.f ? b.v : a.v + b.v,
// a.f | b.f, a.p + b.p).
struct ScanPart {
  uint32_t v, f, p;
};

__device__ __forceinline__ ScanPart scan_combine(ScanPart a, ScanPart b) {
  return {b.f ? b.v : a.v + b.v, a.f | b.f, a.p + b.p};
}

// Inclusive scan of x over the warp's lanes in lane order.
__device__ __forceinline__ ScanPart warp_scan(ScanPart x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    ScanPart y;
    y.v = __shfl_up_sync(0xFFFFFFFFu, x.v, off);
    y.f = __shfl_up_sync(0xFFFFFFFFu, x.f, off);
    y.p = __shfl_up_sync(0xFFFFFFFFu, x.p, off);
    if (lane >= off) x = scan_combine(y, x);
  }
  return x;
}

// The carry between K12-delta's tiles: a single-pass decoupled
// look-back over status words in a scratch that the wrapper
// keeps per device. state[0] is the epoch of the last finished call; the
// call's epoch is the next one (1 .. 2^30 - 1, so a zeroed scratch holds
// none). Each tile has 32 bytes of status, 64-bit words of value | epoch
// << 34 | head << 33: its aggregate, segmented then plain (written once,
// in one 16-byte store), then its inclusive segmented prefix (written
// once, later); a word of another epoch is not yet written. Tiles are
// taken in blockIdx order. state[1] counts the CTAs that have read the
// epoch; the last of them advances state[0] and resets the count as it
// exits. No memset runs between calls, CUDA graph replays included.
constexpr uint64_t kStatusHead = 1ull << 33;
constexpr uint32_t kEpochs = (1u << 30) - 1u;

__device__ __forceinline__ uint64_t status_word(uint32_t value, uint32_t epoch,
                                                bool head) {
  return value | (static_cast<uint64_t>(epoch) << 34) |
         (head ? kStatusHead : 0ull);
}

__device__ __forceinline__ bool status_of(uint64_t w, uint32_t epoch) {
  return static_cast<uint32_t>(w >> 34) == epoch;
}

// A tile's status: its aggregate words (one load) and its inclusive word.
struct TileStatus {
  uint64_t seg, plain, incl;
};

__device__ __forceinline__ void load_status(const uint64_t* p, TileStatus* s) {
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];"
               : "=l"(s->seg), "=l"(s->plain) : "l"(p) : "memory");
  asm volatile("ld.volatile.global.u64 %0, [%1];"
               : "=l"(s->incl) : "l"(p + 2) : "memory");
}

// Spins until tile p's aggregate is of this epoch (its inclusive word may
// still be missing); traps (a launch fault the wrapper's caller sees)
// rather than spin for ever on a word that is never written.
__device__ __forceinline__ void await_status(const uint64_t* p, uint32_t epoch,
                                             TileStatus* s) {
  uint32_t spins = 0u;
  while (!status_of(s->seg, epoch) || !status_of(s->plain, epoch)) {
    if (++spins == (1u << 26)) __trap();
    load_status(p, s);
  }
}

// Whether the segmented sum stops at this tile (it holds a head, or its
// inclusive prefix is written), and what the tile adds to it.
__device__ __forceinline__ bool seg_stop(const TileStatus& s, uint32_t epoch) {
  return (s.seg & kStatusHead) != 0ull || status_of(s.incl, epoch);
}

__device__ __forceinline__ uint32_t seg_value(const TileStatus& s,
                                              uint32_t epoch) {
  return static_cast<uint32_t>((s.seg & kStatusHead) != 0ull ||
                                       !status_of(s.incl, epoch)
                                   ? s.seg
                                   : s.incl);
}

// The sum (the max) of every thread's x across the CTA, to every thread;
// red: 32 words of shared memory, free again on return.
__device__ __forceinline__ uint32_t cta_sum(uint32_t x, uint32_t* red) {
  x = __reduce_add_sync(0xFFFFFFFFu, x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = 0u;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) x += red[w];
  __syncthreads();
  return x;
}

__device__ __forceinline__ int cta_max(int x, uint32_t* red) {
  x = __reduce_max_sync(0xFFFFFFFFu, x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = static_cast<uint32_t>(x);
  __syncthreads();
  x = -1;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    x = max(x, static_cast<int>(red[w]));
  }
  __syncthreads();
  return x;
}

struct LookbackCarry {
  uint32_t* state;

  // Thread 0 reads the epoch, then counts its CTA among the readers (its
  // value is stored before the count, so it has been read).
  __device__ __forceinline__ uint32_t begin(uint32_t* epoch) const {
    uint32_t ticket = 0u;
    if (threadIdx.x == 0) {
      *epoch = *reinterpret_cast<const volatile uint32_t*>(state) % kEpochs + 1u;
      ticket = atomicAdd(state + 1, 1u);
    }
    return ticket;
  }

  // The segmented sum stops at the first tile back that holds a head or
  // whose inclusive prefix is written. Warp 0 reads the 32 tiles before
  // this one, a lane each (enough at the mesh's 16 banks: a head a few
  // tiles back); past them (a bank over many tiles) the whole CTA reads
  // every earlier tile at once, a few each, finds the latest stop and
  // adds the aggregates after it (written once, so the two reads agree),
  // two trips to L2 and not one each 32 tiles. A tile that holds a
  // padding lane also needs the plain sum of every tile before it, read
  // the same way.
  __device__ __forceinline__ ScanPart exchange(ScanPart total, int tile,
                                               const uint32_t* epoch_s,
                                               bool pads) const {
    constexpr int kBatch = 4;  // tiles a thread has in flight
    __shared__ uint32_t seg_in, more;
    __shared__ uint32_t red[32];
    uint64_t* status = reinterpret_cast<uint64_t*>(state + 4);
    const uint32_t epoch = *epoch_s;
    const int tid = static_cast<int>(threadIdx.x);
    const int lane = tid & 31;
    const int nt = static_cast<int>(blockDim.x);
    if (tid == 0) {
      asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};" ::"l"(
                       status + 4 * tile),
                   "l"(status_word(total.v, epoch, total.f != 0u)),
                   "l"(status_word(total.p, epoch, false))
                   : "memory");
    }
    if (tid < 32) {
      uint32_t sv = 0u;
      unsigned m = 1u;
      if (tile > 0) {
        const int j = tile - 1 - lane;
        TileStatus st{kStatusHead, 0ull, 0ull};  // before tile 0: a stop
        if (j >= 0) {
          load_status(status + 4 * j, &st);
          await_status(status + 4 * j, epoch, &st);
        }
        m = __ballot_sync(0xFFFFFFFFu, seg_stop(st, epoch));
        const int last = m ? __ffs(m) - 1 : 31;
        sv = __reduce_add_sync(0xFFFFFFFFu,
                               lane <= last ? seg_value(st, epoch) : 0u);
      }
      if (lane == 0) {
        seg_in = sv;
        more = m == 0u;
      }
    }
    __syncthreads();
    if (more) {  // no stop in the 32 tiles before: tiles [0, top)
      const int top = tile - 32;
      int stop = -1;
      for (int j0 = top - 1 - tid; j0 >= 0; j0 -= kBatch * nt) {
        TileStatus st[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          if (j0 - q * nt >= 0) load_status(status + 4 * (j0 - q * nt), &st[q]);
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const int j = j0 - q * nt;
          if (j >= 0) {
            await_status(status + 4 * j, epoch, &st[q]);
            if (seg_stop(st[q], epoch)) stop = max(stop, j);
          }
        }
      }
      // No stop (-1): the sum runs from tile 0, whose aggregate is its
      // inclusive prefix.
      stop = cta_max(stop, red);
      uint32_t add = 0u;
      for (int j = top - 1 - tid; j >= max(stop, 0); j -= nt) {
        TileStatus st;
        load_status(status + 4 * j, &st);  // written
        // The stop tile's inclusive word, when it holds no head, was
        // written before the first read saw it.
        add += j == stop ? seg_value(st, epoch)
                         : static_cast<uint32_t>(st.seg);
      }
      add = cta_sum(add, red);
      if (tid == 0) seg_in += add;
      __syncthreads();
    }
    const uint32_t sv = seg_in;
    if (tid == 0) {
      asm volatile("st.volatile.global.u64 [%0], %1;" ::"l"(status + 4 * tile +
                                                              2),
                   "l"(status_word(total.f ? total.v : sv + total.v, epoch,
                                   false))
                   : "memory");
    }
    uint32_t pv = 0u;
    if (pads) {
      for (int j0 = tid; j0 < tile; j0 += kBatch * nt) {
        TileStatus st[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          if (j0 + q * nt < tile) load_status(status + 4 * (j0 + q * nt), &st[q]);
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const int j = j0 + q * nt;
          if (j < tile) {
            await_status(status + 4 * j, epoch, &st[q]);
            pv += static_cast<uint32_t>(st[q].plain);
          }
        }
      }
      pv = cta_sum(pv, red);
    }
    return ScanPart{sv, tile > 0 ? 1u : 0u, pv};
  }

  // The last CTA to read the epoch makes it the last finished call's.
  __device__ __forceinline__ void end(uint32_t ticket,
                                      const uint32_t* epoch_s) const {
    if (threadIdx.x == 0 && ticket == gridDim.x - 1u) {
      state[1] = 0u;
      state[0] = *epoch_s;
    }
  }
};

// K12-delta in one launch: CTAs of T threads, L consecutive lanes a
// thread, a tile of T x L lanes a CTA. Each thread loads its lanes'
// deltas and finds their banks and heads (Header), then scans them
// serially in registers (segmented: restarted at each bank's first lane;
// and plain); the thread totals are scanned across the warp with shuffles
// and across the CTA's warps from shared memory; the look-back brings the
// tile's carry from the tiles before it. A real lane's key is its bank's
// base plus its segmented prefix; a padding lane's bank 0's base plus its
// plain prefix (as DeltaDecode).
template <int T, int L, class Header>
__global__ void __launch_bounds__(T)
decode_delta_scan_kernel(const uint32_t* __restrict__ buf, int num_banks,
                         int db, int lanes, uint32_t* __restrict__ keys,
                         int32_t* __restrict__ bank, LookbackCarry carry) {
  constexpr int kW = T / 32;
  constexpr int kTile = T * L;
  extern __shared__ uint32_t starts[];
  __shared__ ScanPart warp_part[kW];
  __shared__ uint32_t epoch;
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = static_cast<int>(blockIdx.x);
  const uint32_t t0 = static_cast<uint32_t>(tile) * kTile;
  const int i0 = static_cast<int>(t0) + tid * L;
  const int n = max(0, min(L, lanes - i0));
  const uint32_t ticket = carry.begin(&epoch);
  uint32_t d[L];
  load_fields<L>(buf + 2 * num_banks, i0, db, n, d);  // in flight
  Header hdr;
  hdr.template init<T, kTile>(buf, num_banks, t0, starts);
  hdr.load_bases(buf + num_banks, num_banks);  // in flight
  const uint32_t total = hdr.total();

  // Each lane's bank (-1 past the real lanes) and head bit, and the
  // thread's totals.
  ScanPart mine{0u, 0u, 0u};
  int32_t b[L];
  uint32_t heads = 0u;
  int32_t cur = hdr.first();
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint32_t i = static_cast<uint32_t>(i0 + j);
    const bool real = j < n && i < total;
    cur = hdr.bank(i, cur);
    const uint32_t start = hdr.start_of(cur);  // every lane: a shuffle
    const bool head = real && start == i;
    b[j] = real ? cur : -1;
    heads |= head ? 1u << j : 0u;
    mine.v = head ? d[j] : mine.v + d[j];
    mine.f |= head ? 1u : 0u;
    mine.p += d[j];
  }
  const ScanPart incl = warp_scan(mine, lane);
  if (lane == 31) warp_part[warp] = incl;
  __syncthreads();
  // The warps before this one, and the tile's total.
  ScanPart before{0u, 0u, 0u};
  ScanPart tile_total{0u, 0u, 0u};
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    const ScanPart y = warp_part[w];
    if (w < warp) before = scan_combine(before, y);
    tile_total = scan_combine(tile_total, y);
  }
  const bool pads = min(t0 + kTile, static_cast<uint32_t>(lanes)) > total;
  const ScanPart in = carry.exchange(tile_total, tile, &epoch, pads);

  // The thread's exclusive prefix: the tile's carry, the warps before its
  // own, the lanes of its warp before it.
  ScanPart x = scan_combine(in, before);
  ScanPart lane_in;
  lane_in.v = __shfl_up_sync(0xFFFFFFFFu, incl.v, 1);
  lane_in.f = __shfl_up_sync(0xFFFFFFFFu, incl.f, 1);
  lane_in.p = __shfl_up_sync(0xFFFFFFFFu, incl.p, 1);
  if (lane > 0) x = scan_combine(x, lane_in);

  // The keys: a real lane's its bank's base plus its segmented prefix, a
  // padding lane's bank 0's base plus its plain prefix.
  const uint32_t base0 = hdr.base0();
  uint32_t v = x.v;
  uint32_t p = x.p;
  uint32_t k[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint32_t dj = d[j];
    const uint32_t base = hdr.base_of(b[j] < 0 ? 0 : b[j]);
    v = (heads >> j) & 1u ? dj : v + dj;
    k[j] = b[j] >= 0 ? base + v : base0 + p + dj;
    p += dj;
  }
  store_lanes<L>(keys, bank, i0, lanes - i0, k, b);
  carry.end(ticket, &epoch);
}

// ---------------------------------------------------------------------------
// K3: the roster preload, binned by filter tile. The filter is cut into
// tiles of 2^log2_bpt whole 64-byte blocks (at most 512: 32 KB of shared
// memory). Three kernels after a memset of the per-tile totals:
//   count   each CTA hashes its chunk of keys and counts them per tile in
//           shared memory; it keeps the counts per (CTA, tile) and
//           reserves its range in every non-empty tile with one global
//           atomicAdd (the returned offset is kept per (CTA, tile) too);
//   scatter each CTA scans the tile totals into tile starts and its own
//           counts into a local order, sorts its chunk by tile in shared
//           memory (each key as a 27-bit payload: the block within the
//           tile, h2 & 511 and h3 & 511; the probe offsets need no more),
//           and writes each tile's run to its reserved range whole, so
//           the writes coalesce;
//   or      one CTA per tile loads its slice of the filter into shared
//           memory with 16-byte loads, ORs every key's k probe bits there
//           with shared atomicOr, and writes the slice back with 16-byte
//           stores.
// Global atomics fall from k per key to one per (CTA, non-empty tile), and
// each filter word is read and written once. OR is order-free, so the
// words equal those of the JAX sort/segmented-OR scatter exactly, onto
// whatever the filter already holds.
// Scratch (uint32): totals[tiles], starts[tiles + 1],
// counts[ctas * tiles], offsets[ctas * tiles], payload[n].
//
// The same passes are K11's, the mesh engine's preload of one grid cell:
// `words` then holds blocks [first_block, first_block + slice_blocks) of
// a filter of num_blocks blocks, the tiles cover the slice only, and the
// count and scatter passes drop a key whose block lies outside it (one
// unsigned test of the block less first_block, as K9 makes) or whose
// mask byte is 0 (mask may be null). K3 passes the whole filter
// (first_block 0, slice_blocks = num_blocks) and no mask. The payload
// is sized for every key, the case of a mesh with one slice.
// ---------------------------------------------------------------------------
constexpr int kPayloadBlockBits = 9;  // log2 of the most blocks in a tile

// Keys a thread loads before it uses any, in the preload's key loops.
constexpr int kKeyUnroll = 4;

// A preload's keys and the slice they go into: rel() is a key's block
// less first_block (unsigned, so a block below the slice wraps past
// slice_blocks), or slice_blocks when the key is dropped.
struct SliceKeys {
  const uint32_t* keys;
  const uint8_t* mask;  // may be null: every key
  uint32_t first_block, slice_blocks, num_blocks;
  uint64_t magic;

  __device__ __forceinline__ uint32_t rel(uint32_t key, bool kept) const {
    const uint32_t r =
        fastmod(murmur3_u32(key, kSeedBloomA), magic, num_blocks) -
        first_block;
    return kept && r < slice_blocks ? r : slice_blocks;
  }
};

// Loads keys i0 + u * kThreads (u < kKeyUnroll) below `end`, and their
// mask bytes, before any is used.
__device__ __forceinline__ void load_key_batch(const SliceKeys& sk, int i0,
                                               int end, uint32_t* key,
                                               bool* kept) {
#pragma unroll
  for (int u = 0; u < kKeyUnroll; ++u) {
    const int i = i0 + u * kThreads;
    key[u] = i < end ? __ldg(sk.keys + i) : 0u;
    kept[u] = i < end && (sk.mask == nullptr || __ldg(sk.mask + i) != 0);
  }
}

__global__ void __launch_bounds__(kThreads)
bloom_tile_count_kernel(SliceKeys sk, int n, int chunk, int log2_bpt,
                        int tiles, uint32_t* totals,
                        uint32_t* __restrict__ counts,
                        uint32_t* __restrict__ offsets) {
  extern __shared__ uint32_t hist[];
  for (int t = threadIdx.x; t < tiles; t += kThreads) hist[t] = 0u;
  __syncthreads();
  const int begin = blockIdx.x * chunk;
  const int end = min(n, begin + chunk);
  for (int i0 = begin + threadIdx.x; i0 < end;
       i0 += kThreads * kKeyUnroll) {
    uint32_t key[kKeyUnroll];
    bool kept[kKeyUnroll];
    load_key_batch(sk, i0, end, key, kept);
#pragma unroll
    for (int u = 0; u < kKeyUnroll; ++u) {
      const uint32_t rel = sk.rel(key[u], kept[u]);
      if (rel < sk.slice_blocks) atomicAdd(hist + (rel >> log2_bpt), 1u);
    }
  }
  __syncthreads();
  const size_t row = static_cast<size_t>(blockIdx.x) * tiles;
  for (int t = threadIdx.x; t < tiles; t += kThreads) {
    const uint32_t c = hist[t];
    counts[row + t] = c;
    if (c != 0u) offsets[row + t] = atomicAdd(totals + t, c);
  }
}

__global__ void __launch_bounds__(kThreads)
bloom_tile_scatter_kernel(SliceKeys sk, int n, int chunk, int log2_bpt,
                          int tiles,
                          const uint32_t* __restrict__ totals,
                          const uint32_t* __restrict__ counts,
                          const uint32_t* __restrict__ offsets,
                          uint32_t* __restrict__ starts,
                          uint32_t* __restrict__ payload) {
  // Shared memory: base[tiles + 1] (first the tiles' global starts, then
  // where this CTA's run of each tile goes), local[tiles + 1] (where each
  // tile's run begins in this CTA's sorted chunk), cursor[tiles] (the next
  // free place of each run), sorted[chunk].
  extern __shared__ uint32_t smem[];
  uint32_t* base = smem;
  uint32_t* local = base + tiles + 1;
  uint32_t* cursor = local + tiles + 1;
  uint32_t* sorted = cursor + tiles;
  const size_t row = static_cast<size_t>(blockIdx.x) * tiles;
  cta_exclusive_scan([=](int t) { return totals[t]; }, tiles, base);
  cta_exclusive_scan([=](int t) { return counts[row + t]; }, tiles, local);
  for (int t = threadIdx.x; t <= tiles; t += kThreads) {
    if (blockIdx.x == 0) starts[t] = base[t];
    if (t < tiles) {
      cursor[t] = local[t];
      if (local[t + 1] != local[t]) base[t] += offsets[row + t];
    }
  }
  __syncthreads();
  const uint32_t tile_mask = (1u << log2_bpt) - 1u;
  const int begin = blockIdx.x * chunk;
  const int end = min(n, begin + chunk);
  for (int i0 = begin + threadIdx.x; i0 < end;
       i0 += kThreads * kKeyUnroll) {
    uint32_t key[kKeyUnroll];
    bool kept[kKeyUnroll];
    load_key_batch(sk, i0, end, key, kept);
#pragma unroll
    for (int u = 0; u < kKeyUnroll; ++u) {
      const uint32_t rel = sk.rel(key[u], kept[u]);
      if (rel < sk.slice_blocks) {
        const uint32_t h2 = (murmur3_u32(key[u], kSeedBloomB) | 1u) & 511u;
        const uint32_t h3 = (murmur3_u32(key[u], kSeedBlock) | 1u) & 511u;
        sorted[atomicAdd(cursor + (rel >> log2_bpt), 1u)] =
            (rel & tile_mask) | (h2 << kPayloadBlockBits) |
            (h3 << (kPayloadBlockBits + 9));
      }
    }
  }
  __syncthreads();
  // Each warp writes whole runs: tile t's run goes to its range reserved
  // by the count pass.
  const int lane = static_cast<int>(threadIdx.x & 31);
  for (int t = threadIdx.x >> 5; t < tiles; t += kWarps) {
    const uint32_t lo = local[t];
    const uint32_t hi = local[t + 1];
    uint32_t* out = payload + base[t];
    for (uint32_t i = lo + lane; i < hi; i += 32) out[i - lo] = sorted[i];
  }
}

// OR one key's k probe bits into its 16-word block ``blk`` (shared
// memory), with one atomicOr per distinct word: the mask of word w
// gathers every probe that lands in w.
__device__ __forceinline__ void or_block_probes(uint32_t* blk, uint32_t h2,
                                                uint32_t h3, int k) {
  uint32_t seen = 0u;
  for (int j = 0; j < k; ++j) {
    const uint32_t w = ((h2 + static_cast<uint32_t>(j) * h3) & 511u) >> 5;
    if ((seen >> w) & 1u) continue;
    seen |= 1u << w;
    uint32_t mask = 0u;
    for (int j2 = j; j2 < k; ++j2) {
      const uint32_t off = (h2 + static_cast<uint32_t>(j2) * h3) & 511u;
      if ((off >> 5) == w) mask |= 1u << (off & 31u);
    }
    atomicOr(blk + w, mask);
  }
}

// K3 and K11 for a small batch (their wrappers pick it below
// K3_BINNED_MIN_KEYS and K11_BINNED_MIN_KEYS keys, where the binned
// passes' fixed cost of chained launches and scans is more than the
// atomics they save): one thread per key, a division-free block index,
// and one global atomicOr per distinct word of the key. A slice and a
// mask drop keys as in the binned passes (SliceKeys).
__global__ void __launch_bounds__(kThreads)
bloom_add_keys_kernel(uint32_t* words, SliceKeys sk, int n, int k) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n || (sk.mask != nullptr && __ldg(sk.mask + i) == 0)) return;
  const uint32_t key = __ldg(sk.keys + i);
  const uint32_t rel = sk.rel(key, true);
  if (rel >= sk.slice_blocks) return;
  or_block_probes(words + static_cast<size_t>(rel) * 16u,
                  (murmur3_u32(key, kSeedBloomB) | 1u) & 511u,
                  (murmur3_u32(key, kSeedBlock) | 1u) & 511u, k);
}

// Payloads a thread loads before it uses any, in the OR pass.
constexpr int kPayloadUnroll = 8;

__global__ void __launch_bounds__(kThreads)
bloom_tile_or_kernel(uint32_t* words, uint32_t num_blocks, int log2_bpt,
                     int k, const uint32_t* __restrict__ starts,
                     const uint32_t* __restrict__ payload) {
  extern __shared__ uint4 tile[];
  const uint32_t first = static_cast<uint32_t>(blockIdx.x) << log2_bpt;
  const int nvec = static_cast<int>(
      min(1u << log2_bpt, num_blocks - first) * 4u);
  uint4* slice = reinterpret_cast<uint4*>(words) + static_cast<size_t>(first) * 4u;
  for (int v = threadIdx.x; v < nvec; v += kThreads) tile[v] = slice[v];
  __syncthreads();
  uint32_t* tile32 = reinterpret_cast<uint32_t*>(tile);
  const uint32_t s = starts[blockIdx.x];
  const uint32_t e = starts[blockIdx.x + 1];
  for (uint32_t i0 = s + threadIdx.x; i0 < e;
       i0 += kThreads * kPayloadUnroll) {
    uint32_t p[kPayloadUnroll];
#pragma unroll
    for (int u = 0; u < kPayloadUnroll; ++u) {
      const uint32_t i = i0 + u * kThreads;
      p[u] = i < e ? __ldcs(payload + i) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kPayloadUnroll; ++u) {
      if (i0 + u * kThreads < e) {
        const uint32_t local = p[u] & ((1u << kPayloadBlockBits) - 1u);
        const uint32_t h2 = (p[u] >> kPayloadBlockBits) & 511u;
        const uint32_t h3 = (p[u] >> (kPayloadBlockBits + 9)) & 511u;
        // One shared atomicOr per probe: merging a key's probes per word
        // first (as the per-key path does for its global atomics) costs
        // more here than the shared atomics it saves (PERF.md).
        for (int j = 0; j < k; ++j) {
          const uint32_t off = (h2 + static_cast<uint32_t>(j) * h3) & 511u;
          atomicOr(tile32 + local * 16u + (off >> 5), 1u << (off & 31u));
        }
      }
    }
  }
  __syncthreads();
  for (int v = threadIdx.x; v < nvec; v += kThreads) slice[v] = tile[v];
}

// ---------------------------------------------------------------------------
// K4: one thread per key through K2's warp_bloom_probe, which reads the
// key's one 64-byte block of the packed words (blocks are contiguous
// there, so no transposed or row table as on the TPU). Any batch length;
// no padding (lanes past the batch take part in the warp's loads only).
// Also K8's probe of a blocked filter's packed image.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
bloom_contains_kernel(const uint32_t* __restrict__ words, uint32_t num_blocks,
                      uint64_t magic, int k, const uint32_t* __restrict__ keys,
                      int n, uint8_t* __restrict__ out) {
  __shared__ uint4 stage[kWarps * 128];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const uint32_t key = i < n ? keys[i] : 0u;
  // K8's blocked image path launches this kernel as the programmatic
  // dependent of its pack pass, which writes `words`; launched alone, the
  // wait returns at once.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const bool hit = warp_bloom_probe(words, num_blocks, magic, k, key, i < n,
                                    stage + (threadIdx.x >> 5) * 128);
  if (i < n) out[i] = hit ? 1 : 0;
}

// ---------------------------------------------------------------------------
// K5: one thread per lane. A lane is dropped when its valid byte is 0
// (valid may be null: every lane counts) or its bank is < 0 or past the
// array; otherwise its rank is maxed into its register with a 32-bit CAS
// loop (atomic_max_u8, as K2). The valid byte, the bank and the key are
// loaded together, before any of them is looked at, so they cost one
// memory trip; then the register word is read and, only if the rank is
// higher, swapped. 2 or 4 lanes per thread and a warp match that folds
// the lanes on one register word were slower at every shape measured; a
// first CAS on an assumed zero word was faster into fresh registers but
// slower where they already held the ranks (PERF.md).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
hll_add_kernel(uint8_t* regs, int num_banks, int precision,
               const int32_t* __restrict__ bank,
               const uint32_t* __restrict__ keys,
               const uint8_t* __restrict__ valid, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const uint32_t key = i < n ? keys[i] : 0u;
  const int32_t b = i < n ? bank[i] : -1;
  const bool ok = i < n && (valid == nullptr || valid[i] != 0);
  // Hashed before the lane is judged, so that the key's load is not moved
  // below the check into a second trip.
  uint32_t bucket, rank;
  hll_bucket_rank(key, precision, &bucket, &rank);
  if (!ok || b < 0 || b >= num_banks) return;
  atomic_max_u8(regs + (static_cast<size_t>(b) << precision) + bucket, rank);
}

// ---------------------------------------------------------------------------
// K9 and K10: the mesh engine's step (attendance_tpu_torch/parallel/
// sharded.py) on one grid cell (r, s), which holds slice s of the filter
// (whole 512-bit blocks [first_block, first_block + slice_blocks)) and of
// every bank's registers ([lo, lo + regs_local)). Positions come from the
// whole filter's block count and the whole register width, never the
// slice's, so a key's answer and its register are the same on every mesh
// shape. A lane is keys[i], or with key_bits > 0 the word wire's words[i]
// (WireDecode: the key in the low key_bits bits, the bank above, all ones
// on a pad lane).
//
// K9: out[i] = 1 when every probe of lane i's key that falls in the slice
// is set, or when none does. A key's k probes lie in one block, so the
// slice either holds all of them or none: one test of the block, then
// K4's warp-wide probe (warp_bloom_probe_block) on the slice. The engine
// ANDs the cells' answers across sp before any K10 (a fused probe-and-add
// per cell would count a key that another slice rejects).
//
// Two paths, picked by the wrapper from the slice's share of the filter
// (ops/kernels.py bloom_contains_slice):
//   direct   every lane of a warp takes part in the probe, a lane outside
//            the slice on block 0 (it answers 1 whatever it reads). For a
//            slice of half the filter or more, where most lanes are in it.
//   compact  keys hash uniformly over the blocks, so on a slice of 1/sp of
//            the filter only about 256 / sp lanes of a CTA are in it. Each
//            warp puts its in-slice lanes' (key, block, thread) into its
//            own 32 slots of shared memory (a ballot, ranks by popcount)
//            and a lane outside the slice writes its 1 at once; after one
//            __syncthreads the first ceil(m / 32) warps of the CTA run the
//            probe on its m compacted lanes (each slot finds its source
//            from the warps' counts) and write the answers straight to
//            out. The hash of h2 and h3, the staged loads and the k-bit
//            test are issued for about a quarter of the warps at sp = 4.
//            On an NVIDIA H100 80GB HBM3 at 700 W it was 4-9% faster
//            than direct at 131,072 lanes on sp = 4 and 8, 23-29% at
//            1,048,576, even at 65,536, and 4-13% slower on sp = 2 at
//            65,536 (PERF.md). A warp vote that skips the probe of a warp
//            with no in-slice lane, a compaction within each warp, a
//            compaction with a CTA-wide scan and three barriers, and K9
//            and K10 each decoding a narrow wire themselves were measured
//            and not kept (PERF.md).
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t slice_rel(const uint32_t* __restrict__ keys,
                                              int key_bits, int n, int i,
                                              uint32_t first_block,
                                              uint32_t num_blocks,
                                              uint64_t magic, uint32_t* key) {
  uint32_t k = i < n ? keys[i] : 0u;
  if (key_bits > 0) k &= (1u << key_bits) - 1u;
  *key = k;
  // Unsigned: a block below the slice wraps past slice_blocks.
  return fastmod(murmur3_u32(k, kSeedBloomA), magic, num_blocks) -
         first_block;
}

__global__ void __launch_bounds__(kThreads)
bloom_contains_slice_kernel(const uint32_t* __restrict__ words,
                            uint32_t first_block, uint32_t slice_blocks,
                            uint32_t num_blocks, uint64_t magic, int k,
                            const uint32_t* __restrict__ keys, int key_bits,
                            int n, uint8_t* __restrict__ out) {
  __shared__ uint4 stage[kWarps * 128];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  uint32_t key;
  const uint32_t rel =
      slice_rel(keys, key_bits, n, i, first_block, num_blocks, magic, &key);
  const bool mine = i < n && rel < slice_blocks;
  const bool hit = warp_bloom_probe_block(words, mine ? rel : 0u, k, key,
                                          mine, stage + (threadIdx.x >> 5) * 128);
  if (i < n) out[i] = (hit || !mine) ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
bloom_contains_slice_compact_kernel(const uint32_t* __restrict__ words,
                                    uint32_t first_block,
                                    uint32_t slice_blocks, uint32_t num_blocks,
                                    uint64_t magic, int k,
                                    const uint32_t* __restrict__ keys,
                                    int key_bits, int n,
                                    uint8_t* __restrict__ out) {
  __shared__ uint4 stage[kWarps * 128];
  __shared__ uint2 slot_key_block[kThreads];
  __shared__ uint8_t slot_thread[kThreads];
  __shared__ int warp_count[kWarps];
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int i = blockIdx.x * kThreads + tid;
  uint32_t key;
  const uint32_t rel =
      slice_rel(keys, key_bits, n, i, first_block, num_blocks, magic, &key);
  const bool mine = i < n && rel < slice_blocks;
  const uint32_t mask = __ballot_sync(0xFFFFFFFFu, mine);
  if (lane == 0) warp_count[warp] = __popc(mask);
  if (mine) {
    uint32_t below;  // the lanes of this warp below this one
    asm("mov.u32 %0, %%lanemask_lt;" : "=r"(below));
    const int at = warp * 32 + __popc(mask & below);
    slot_key_block[at] = make_uint2(key, rel);
    slot_thread[at] = static_cast<uint8_t>(tid);
  }
  if (i < n && !mine) out[i] = 1;
  __syncthreads();
  // Compacted slot `tid` is the (tid - total)-th in-slice lane of the warp
  // whose counts' prefix `total` is the last at or below tid.
  int total = 0;
  int src = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_count[w];
    if (tid >= total && tid < total + c) src = w * 32 + (tid - total);
    total += c;
  }
  if (warp * 32 < total) {  // warp-uniform: the probe is warp-wide
    const bool present = tid < total;
    const uint2 kb = present ? slot_key_block[src] : make_uint2(0u, 0u);
    const bool hit = warp_bloom_probe_block(words, kb.y, k, kb.x, present,
                                            stage + warp * 128);
    if (present) out[blockIdx.x * kThreads + slot_thread[src]] = hit ? 1 : 0;
  }
}

// K10: K5 on the cell's register slice. Lane i is real when its word's
// bank field is not the pad (word wire) or when i < n_real (keys and bank
// arrays, real lanes first); it is kept when it is real, valid[i] != 0,
// 0 <= bank < num_banks and its bucket lies in the slice, and its rank is
// maxed into regs[bank * regs_local + bucket - lo] (atomic_max_u8). With
// counts non-null (the replica's cell s = 0) the CTA also adds its valid
// real lanes and its invalid real lanes to the replica's two-lane counters
// (cta_add_counts, K2's tail). PERF.md records the designs measured
// against it and not kept.
__global__ void __launch_bounds__(kThreads)
hll_add_slice_kernel(uint8_t* regs, int num_banks, int precision, uint32_t lo,
                     uint32_t regs_local, const uint32_t* __restrict__ keys,
                     const int32_t* __restrict__ bank, int key_bits,
                     const uint8_t* __restrict__ valid, int n, int n_real,
                     unsigned long long* counts) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  uint32_t key = 0u;
  int32_t b = -1;
  bool real = false;
  bool ok = false;
  if (i < n) {
    if (key_bits > 0) {
      WireDecode{reinterpret_cast<const uint8_t*>(keys), 0, key_bits, n}.lane(
          i, &key, &b);
      real = b >= 0;
    } else {
      key = keys[i];
      b = bank[i];
      real = i < n_real;
    }
    ok = valid[i] != 0;
  }
  uint32_t bucket, rank;
  hll_bucket_rank(key, precision, &bucket, &rank);
  const uint32_t rel = bucket - lo;  // unsigned: below the slice wraps high
  if (real && ok && b >= 0 && b < num_banks && rel < regs_local) {
    atomic_max_u8(regs + static_cast<size_t>(b) * regs_local + rel, rank);
  }
  if (counts != nullptr) cta_add_counts(real && ok, real && !ok, counts);
}

// ---------------------------------------------------------------------------
// K6: Count-Min over uint32[depth, width] counters. The update adds one
// per (row, bucket) of every unmasked lane with a 32-bit atomicAdd
// (wraps at 2^32 exactly like XLA's uint32 scatter-add; duplicates each
// count). The query, a second launch in stream order so it sees the
// whole batch, takes the min over rows; masked lanes read 0. mask may
// be null: every lane counts. The update is bound by L2 atomic
// throughput (one add per (key, row)); one cooperative launch with a
// grid barrier, and a programmatic-dependent-launch pair, were measured
// on an H100 and neither beat these two launches in every case
// (PERF.md).
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t cms_bucket(uint32_t key, int row,
                                               uint32_t width) {
  return murmur3_u32(key, kSeedCmsBase + static_cast<uint32_t>(row) *
                                             kSeedCmsStep) % width;
}

__global__ void __launch_bounds__(kThreads)
cms_update_kernel(uint32_t* counts, int depth, uint32_t width,
                  const uint32_t* __restrict__ keys,
                  const uint8_t* __restrict__ mask, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  if (mask != nullptr && mask[i] == 0) return;
  const uint32_t key = keys[i];
  for (int r = 0; r < depth; ++r) {
    atomicAdd(counts + static_cast<size_t>(r) * width + cms_bucket(key, r, width),
              1u);
  }
}

__global__ void __launch_bounds__(kThreads)
cms_query_kernel(const uint32_t* __restrict__ counts, int depth,
                 uint32_t width, const uint32_t* __restrict__ keys,
                 const uint8_t* __restrict__ mask, int n,
                 uint32_t* __restrict__ est) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  if (mask != nullptr && mask[i] == 0) {
    est[i] = 0u;
    return;
  }
  const uint32_t key = keys[i];
  uint32_t m = 0xFFFFFFFFu;
  for (int r = 0; r < depth; ++r) {
    m = min(m, counts[static_cast<size_t>(r) * width + cms_bucket(key, r, width)]);
  }
  est[i] = m;
}


// ---------------------------------------------------------------------------
// K7 and K8: the byte-per-bit Bloom filter of the generic sketch store,
// uint8[m_bits] holding 0 or 1 per filter bit (replace the XLA programs
// bloom_add and bloom_contains, attendance_tpu/models/bloom.py:143,158,
// jitted in sketch/tpu_store.py:59-76). Probe positions are those of the
// packed filter: flat (h1 + j*h2) mod m_bits, the sum wrapping mod 2^32
// before the modulo as jnp.uint32 does (m_bits is not a power of two);
// blocked (h1 mod num_blocks) * 512 + ((h2 + j*h3) & 511).
//
// Each kernel has two paths, picked by the wrapper from the batch length
// and the filter's size (ops/kernels.py bloom_bytes_plan):
//   direct  one thread per key straight on the filter's bytes: K7 stores
//           byte 1 at each probe (every store writes the same value, so
//           races are benign), K8 ANDs the k probe bytes, loaded with no
//           early exit so they are in flight together. Each probe is its
//           own 32-byte L2 sector: at scale K7's scattered byte stores
//           and K8's sector reads bind, not the bytes the filter holds.
//   image   the filter as a packed bit image (bit pos at word pos >> 5,
//           bit pos & 31: pack_bloom_bits' layout), 8x smaller than its
//           bytes (the wrapper keeps it under 225 KiB, so a CTA's shared
//           memory holds it whole; the 100k-roster filter's is 117-135
//           KiB).
//           K8: a pack pass reads the bytes once with 16-byte loads into
//           an image in scratch; then, as its programmatic dependent, the
//           flat layout's probe copies the image into every CTA with TMA
//           bulk copies that complete on an mbarrier (each CTA of a
//           cluster fetches a share and multicasts it to all, so one L2
//           read feeds several SMs) and grid-strides over the keys,
//           testing bits in shared memory; the blocked layout's image is
//           K4's packed layout, and K4 probes it (each key's 64-byte block
//           read once, by a quad).
//           K7: pass 1, on up to a few dozen CTAs, sets each CTA's share
//           of the keys' bits in a zeroed image in shared memory with
//           shared atomicOr and stores it as a partial image in scratch;
//           pass 2, its programmatic dependent, ORs the partials of each
//           128-bit image vector and rewrites the matching 128 filter
//           bytes with 16-byte loads and stores, new bits to 1 and every
//           other byte kept. No global atomic, and the filter is read and
//           written once, coalesced.
// ---------------------------------------------------------------------------
constexpr uint32_t kBlockBits = 512;
constexpr int kImageThreads = 1024;
// K8's direct path runs CTAs of this many threads (64 CTAs for the
// processor's 8,192-key batch; 64 and 256 were no faster on an NVIDIA
// H100 80GB HBM3 at 700 W), and its flat image probe clusters of this
// many CTAs sharing each image read (1 and 4 were slower; PERF.md).
constexpr int kDirectThreads = 128;
constexpr int kImageCluster = 2;
// The image probe's grid: at least this many keys a CTA, at most one CTA
// an SM (as many clusters as are resident at once).
constexpr int kImageMinKeysPerCta = kImageThreads;
// One bulk copy moves at most this many bytes.
constexpr uint32_t kBulkChunk = 32u * 1024u;

// The filter byte of probe j of a key, for divisor d (m_bits when flat,
// num_blocks when blocked) with magic = fastmod_magic(d).
template <bool kBlocked>
__device__ __forceinline__ uint32_t byte_probe(uint32_t h1, uint32_t h2,
                                               uint32_t h3, uint32_t j,
                                               uint32_t d, uint64_t magic) {
  if (kBlocked) {
    return fastmod(h1, magic, d) * kBlockBits + ((h2 + j * h3) & 511u);
  }
  return fastmod(h1 + j * h2, magic, d);
}

// A key's three probe hashes (h3 only in the blocked layout).
template <bool kBlocked>
__device__ __forceinline__ uint3 byte_hashes(uint32_t key) {
  return make_uint3(murmur3_u32(key, kSeedBloomA),
                    murmur3_u32(key, kSeedBloomB) | 1u,
                    kBlocked ? murmur3_u32(key, kSeedBlock) | 1u : 0u);
}

template <bool kBlocked>
__global__ void __launch_bounds__(kThreads)
bloom_add_bytes_kernel(uint8_t* bits, uint32_t d, uint64_t magic, int k,
                       const uint32_t* __restrict__ keys,
                       const uint8_t* __restrict__ mask, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n || (mask != nullptr && mask[i] == 0)) return;
  const uint3 h = byte_hashes<kBlocked>(keys[i]);
#pragma unroll 4
  for (int j = 0; j < k; ++j) {
    bits[byte_probe<kBlocked>(h.x, h.y, h.z, static_cast<uint32_t>(j), d,
                              magic)] = 1u;
  }
}

template <bool kBlocked>
__global__ void __launch_bounds__(kDirectThreads)
bloom_contains_bytes_kernel(const uint8_t* __restrict__ bits, uint32_t d,
                            uint64_t magic, int k,
                            const uint32_t* __restrict__ keys, int n,
                            uint8_t* __restrict__ out) {
  const int i = blockIdx.x * kDirectThreads + threadIdx.x;
  if (i >= n) return;
  const uint3 h = byte_hashes<kBlocked>(keys[i]);
  bool hit = true;
#pragma unroll 4
  for (int j = 0; j < k; ++j) {
    hit &= __ldg(bits + byte_probe<kBlocked>(h.x, h.y, h.z,
                                             static_cast<uint32_t>(j), d,
                                             magic)) == 1u;
  }
  out[i] = hit ? 1u : 0u;
}

// Bits b of the result: byte b of x equals 1 (b < 4).
__device__ __forceinline__ uint32_t ones_of4(uint32_t x) {
  return ((__vcmpeq4(x, 0x01010101u) & 0x01010101u) * 0x01020408u) >> 24;
}

__device__ __forceinline__ uint32_t ones_of16(uint4 v) {
  return ones_of4(v.x) | ones_of4(v.y) << 4 | ones_of4(v.z) << 8 |
         ones_of4(v.w) << 12;
}

// The pack pass: image word w from filter bytes 32w .. 32w + 31, bit b set
// where byte 32w + b is 1 (pack_bloom_bits on 0/1 bytes). The probe after
// it may start at once (programmatic dependent launch).
__global__ void __launch_bounds__(kThreads)
bloom_pack_bytes_kernel(const uint4* __restrict__ bits, uint32_t words,
                        uint32_t* __restrict__ image) {
  asm volatile("griddepcontrol.launch_dependents;");
  const uint32_t w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= words) return;
  const uint4 lo = __ldg(bits + 2u * w);
  const uint4 hi = __ldg(bits + 2u * w + 1u);
  image[w] = ones_of16(lo) | ones_of16(hi) << 16;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0u;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// Bytes [off, off + len) of the image from global memory into the same
// offset of the shared image of every CTA in `ctas` (a cluster mask),
// completing on the barrier at the same offset in each.
__device__ __forceinline__ void bulk_image_load(uint8_t* smem,
                                                const uint8_t* image,
                                                uint32_t off, uint32_t len,
                                                uint64_t* bar, uint16_t ctas) {
  for (uint32_t c = 0; c < len; c += kBulkChunk) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1], %2, [%3], %4;"
        :: "r"(smem_u32(smem + off + c)), "l"(image + off + c),
           "r"(min(kBulkChunk, len - c)), "r"(smem_u32(bar)), "h"(ctas)
        : "memory");
  }
}

// K8's image path for the flat layout, the probe: each cluster shares the
// image's reads (every CTA fetches a share and multicasts it); every CTA
// then probes keys blockIdx.x * 1024 + t, strided by the grid, kKeyUnroll
// keys a thread in flight. (The blocked layout's image is K4's packed
// layout: K4 probes it.)
__global__ void __launch_bounds__(kImageThreads, 1)
bloom_contains_image_kernel(const uint8_t* __restrict__ image,
                            uint32_t image_bytes, uint32_t m_bits,
                            uint64_t magic, int k,
                            const uint32_t* __restrict__ keys, int n,
                            uint8_t* __restrict__ out) {
  extern __shared__ uint4 image_smem[];
  __shared__ uint64_t full;
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t rank = cluster.block_rank();
  const uint32_t csize = cluster.num_blocks();
  uint8_t* smem = reinterpret_cast<uint8_t*>(image_smem);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem_u32(&full)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Every CTA's barrier is initialised before any copy may signal it.
  cluster.sync();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_u32(&full)), "r"(image_bytes) : "memory");
    // The pack pass, the kernel before this one, wrote the image.
    asm volatile("griddepcontrol.wait;" ::: "memory");
    const uint32_t share = (image_bytes / 16u + csize - 1u) / csize * 16u;
    const uint32_t off = rank * share;
    if (off < image_bytes) {
      bulk_image_load(smem, image, off, min(share, image_bytes - off), &full,
                      static_cast<uint16_t>((1u << csize) - 1u));
    }
  }
  const uint32_t* words = reinterpret_cast<const uint32_t*>(image_smem);
  const int stride = static_cast<int>(gridDim.x) * kImageThreads;
  for (int i0 = static_cast<int>(blockIdx.x * kImageThreads + threadIdx.x);
       i0 < n; i0 += kKeyUnroll * stride) {
    uint32_t key[kKeyUnroll];
#pragma unroll
    for (int u = 0; u < kKeyUnroll; ++u) {
      const int i = i0 + u * stride;
      key[u] = i < n ? __ldg(keys + i) : 0u;
    }
    // The first keys hash while the image is still arriving; later waits
    // find the phase complete and return at once.
    uint3 h[kKeyUnroll];
#pragma unroll
    for (int u = 0; u < kKeyUnroll; ++u) h[u] = byte_hashes<false>(key[u]);
    mbar_wait(&full, 0u);
#pragma unroll
    for (int u = 0; u < kKeyUnroll; ++u) {
      const int i = i0 + u * stride;
      if (i >= n) break;
      uint32_t hit = 1u;
      for (int j = 0; j < k; ++j) {
        const uint32_t pos = byte_probe<false>(
            h[u].x, h[u].y, 0u, static_cast<uint32_t>(j), m_bits, magic);
        hit &= words[pos >> 5] >> (pos & 31u);
      }
      out[i] = static_cast<uint8_t>(hit & 1u);
    }
  }
  // No CTA leaves before every copy into every CTA has landed.
  mbar_wait(&full, 0u);
  cluster.sync();
}

// Filter bytes (4 of a uint32) with byte b set to 1 where bit b of `nib`
// is, kept elsewhere.
__device__ __forceinline__ uint32_t set_ones4(uint32_t old, uint32_t nib) {
  const uint32_t ones = (nib * 0x00204081u) & 0x01010101u;
  return (old & ~(ones * 0xFFu)) | ones;
}

// K7's image path, pass 1: CTA c sets the bits of keys c * 1024 + t,
// strided by the grid, in a zeroed packed image in shared memory with
// shared atomicOr, and stores the image whole as partial image c.
template <bool kBlocked>
__global__ void __launch_bounds__(kImageThreads, 1)
bloom_add_partial_kernel(uint32_t words, uint32_t d, uint64_t magic, int k,
                         const uint32_t* __restrict__ keys,
                         const uint8_t* __restrict__ mask, int n,
                         uint4* __restrict__ partials) {
  asm volatile("griddepcontrol.launch_dependents;");
  extern __shared__ uint4 image_smem[];
  const int nvec = static_cast<int>(words / 4u);
  const int tid = static_cast<int>(threadIdx.x);
  for (int v = tid; v < nvec; v += kImageThreads) {
    image_smem[v] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  uint32_t* image = reinterpret_cast<uint32_t*>(image_smem);
  const int stride = static_cast<int>(gridDim.x) * kImageThreads;
  for (int i0 = static_cast<int>(blockIdx.x) * kImageThreads + tid; i0 < n;
       i0 += kKeyUnroll * stride) {
    uint32_t key[kKeyUnroll];
    bool add[kKeyUnroll];
#pragma unroll
    for (int u = 0; u < kKeyUnroll; ++u) {
      const int i = i0 + u * stride;
      add[u] = i < n && (mask == nullptr || mask[i] != 0);
      key[u] = i < n ? __ldg(keys + i) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kKeyUnroll; ++u) {
      if (!add[u]) continue;
      const uint3 h = byte_hashes<kBlocked>(key[u]);
      for (int j = 0; j < k; ++j) {
        const uint32_t pos = byte_probe<kBlocked>(
            h.x, h.y, h.z, static_cast<uint32_t>(j), d, magic);
        atomicOr(image + (pos >> 5), 1u << (pos & 31u));
      }
    }
  }
  __syncthreads();
  uint4* mine = partials + static_cast<size_t>(blockIdx.x) * nvec;
  for (int v = tid; v < nvec; v += kImageThreads) mine[v] = image_smem[v];
}

// K7's image path, pass 2 (a programmatic dependent of pass 1): eight
// lanes an image vector v (128 filter bits) OR its `parts` partials, a
// lane every eighth partial, meet by shuffles, and each lane rewrites one
// 16-byte vector of the filter's bytes: the new bits' bytes to 1, every
// other byte kept. Every filter byte is read and written once.
__global__ void __launch_bounds__(kThreads)
bloom_merge_partials_kernel(uint8_t* __restrict__ bits, int nvec,
                            const uint4* __restrict__ partials, int parts) {
  const int t = static_cast<int>(blockIdx.x * kThreads + threadIdx.x);
  const int v = t >> 3;
  const int lane8 = t & 7;
  uint4 set = make_uint4(0u, 0u, 0u, 0u);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (v < nvec) {
#pragma unroll 4
    for (int g = lane8; g < parts; g += 8) {
      const uint4 x = partials[static_cast<size_t>(g) * nvec + v];
      set.x |= x.x;
      set.y |= x.y;
      set.z |= x.z;
      set.w |= x.w;
    }
  }
#pragma unroll
  for (int s = 1; s < 8; s <<= 1) {
    set.x |= __shfl_xor_sync(0xFFFFFFFFu, set.x, s);
    set.y |= __shfl_xor_sync(0xFFFFFFFFu, set.y, s);
    set.z |= __shfl_xor_sync(0xFFFFFFFFu, set.z, s);
    set.w |= __shfl_xor_sync(0xFFFFFFFFu, set.w, s);
  }
  if (v >= nvec) return;
  // Lane q: filter bytes 128v + 16q .. + 15, bits 16q .. 16q + 15 of v.
  const uint32_t w = lane8 < 2 ? set.x : lane8 < 4 ? set.y
                   : lane8 < 6 ? set.z : set.w;
  const uint32_t bits16 = (w >> (16 * (lane8 & 1))) & 0xFFFFu;
  uint4* dst = reinterpret_cast<uint4*>(bits) + 8 * static_cast<size_t>(v) +
               lane8;
  const uint4 old = *dst;
  *dst = make_uint4(set_ones4(old.x, bits16 & 0xFu),
                    set_ones4(old.y, (bits16 >> 4) & 0xFu),
                    set_ones4(old.z, (bits16 >> 8) & 0xFu),
                    set_ones4(old.w, (bits16 >> 12) & 0xFu));
}

// ---------------------------------------------------------------------------
// K1-union: histogram of the register max over a list of banks (replaces
// HyperLogLog.count_union's XLA hll_merge chain and histogram,
// attendance_tpu/models/hll.py:363-372). A grid over register slices of
// kUnionSlice (128) registers, so a 2^14-register union is 128 CTAs: each
// thread owns one 16-byte vector of the slice, and the CTA's 32 thread
// groups split the listed rows between them, each keeping a running
// per-byte max (__vmaxu4) with its loads issued four rows at a time. The
// groups' maxima meet in shared memory; each register's value is counted
// into shared bins, and each CTA adds its nonzero bins to the int32 output
// (zeroed by the entry point) with global atomics. Rows are staged through
// shared memory in chunks, clamped into [0, num_banks) as a JAX gather
// clamps, so the register loads do not wait on a row index load. Bound:
// bytes, every listed row's 2^p registers read once (1,024 rows at p = 14:
// 16 MiB, 5 us at 3.35 TB/s); one CTA per union would put all of it
// through one SM.
// ---------------------------------------------------------------------------
constexpr int kUnionLanes = 8;                       // threads per slice
constexpr int kUnionGroups = kThreads / kUnionLanes;  // row groups per CTA
constexpr int kUnionSlice = kUnionLanes * 16;         // registers per CTA
constexpr int kUnionRowChunk = 1024;                  // rows staged at once

__global__ void __launch_bounds__(kThreads)
hll_union_histogram_kernel(const uint8_t* __restrict__ regs, int num_banks,
                           int m, const int32_t* __restrict__ rows,
                           int num_rows, int num_bins,
                           int32_t* __restrict__ out) {
  __shared__ uint4 part[kUnionGroups * kUnionLanes];
  __shared__ int32_t srows[kUnionRowChunk];
  __shared__ uint32_t bins[kHistRows];
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid % kUnionLanes;
  const int group = tid / kUnionLanes;
  const int nvec = m / 16;
  const int vec = static_cast<int>(blockIdx.x) * kUnionLanes + lane;
  if (tid < kHistRows) bins[tid] = 0u;
  uint32_t mx[4] = {0u, 0u, 0u, 0u};
  for (int base = 0; base < num_rows; base += kUnionRowChunk) {
    const int count = min(kUnionRowChunk, num_rows - base);
    __syncthreads();  // the previous chunk's rows are read
    for (int r = tid; r < count; r += kThreads) {
      srows[r] = min(max(__ldg(rows + base + r), 0), num_banks - 1);
    }
    __syncthreads();
    if (vec < nvec) {
      int r = group;
      for (; r + 3 * kUnionGroups < count; r += 4 * kUnionGroups) {
        uint4 x[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          x[u] = __ldg(reinterpret_cast<const uint4*>(
                           regs + static_cast<size_t>(
                                      srows[r + u * kUnionGroups]) *
                                      static_cast<size_t>(m)) +
                       vec);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          mx[0] = __vmaxu4(mx[0], x[u].x);
          mx[1] = __vmaxu4(mx[1], x[u].y);
          mx[2] = __vmaxu4(mx[2], x[u].z);
          mx[3] = __vmaxu4(mx[3], x[u].w);
        }
      }
      for (; r < count; r += kUnionGroups) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(
                                  regs + static_cast<size_t>(srows[r]) *
                                             static_cast<size_t>(m)) +
                              vec);
        mx[0] = __vmaxu4(mx[0], x.x);
        mx[1] = __vmaxu4(mx[1], x.y);
        mx[2] = __vmaxu4(mx[2], x.z);
        mx[3] = __vmaxu4(mx[3], x.w);
      }
    }
  }
  part[group * kUnionLanes + lane] = make_uint4(mx[0], mx[1], mx[2], mx[3]);
  __syncthreads();
  if (tid < kUnionSlice) {
    // Register tid of the slice: byte tid % 16 of lane tid / 16's vector.
    const int l = tid / 16;
    const int byte = tid % 16;
    if (static_cast<int>(blockIdx.x) * kUnionSlice + tid < m) {
      uint32_t v = 0u;
#pragma unroll 8
      for (int g = 0; g < kUnionGroups; ++g) {
        v = max(v, static_cast<uint32_t>(reinterpret_cast<const uint8_t*>(
                       &part[g * kUnionLanes + l])[byte]));
      }
      if (v < static_cast<uint32_t>(num_bins)) atomicAdd(&bins[v], 1u);
    }
  }
  __syncthreads();
  if (tid < num_bins && bins[tid] != 0u) {
    atomicAdd(out + tid, static_cast<int32_t>(bins[tid]));
  }
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

// K1 and K1-rows: one CTA per listed bank (see hll_histogram_kernel).
int launch_histogram(const void* regs, int num_banks, int m,
                     const int32_t* rows, int num_out, int num_bins, void* out,
                     cudaStream_t stream) {
  if (num_out > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        hll_histogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kHistSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    hll_histogram_kernel<<<num_out, kThreads, kHistSmem, stream>>>(
        static_cast<const uint8_t*>(regs), m, num_bins, rows, num_banks,
        static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory a kernel takes without opting in (the K2
// kernels' static shared memory is about 17 KB of the 48 KB default).
constexpr size_t kSmemNoOptIn = 16 * 1024;

// Shared memory of the narrow wires' counts scan: starts[wire_banks + 1].
inline size_t counts_smem(int wire_banks) {
  return sizeof(uint32_t) * (static_cast<size_t>(wire_banks) + 1);
}

// A kernel of `ctas` CTAs of `threads` threads with `smem` bytes of
// dynamic shared memory (a narrow wire's decode). `dependent`: launched as
// a programmatic dependent of the kernel before it on the stream
// (K2-delta's step and K12-delta's two-pass decode after pass 1), so that
// its CTAs may start while that kernel runs.
template <class... Params, class... Args>
int launch_grid(void (*kernel)(Params...), int ctas, int threads, size_t smem,
                bool dependent, cudaStream_t s, Args... args) {
  cudaError_t err = cudaSuccess;
  if (smem > kSmemNoOptIn) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(ctas));
  cfg.blockDim = dim3(static_cast<unsigned int>(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// A kernel of one thread a lane over `lanes` lanes (K2's kernels).
template <class... Params, class... Args>
int launch_lanes(void (*kernel)(Params...), int lanes, size_t smem,
                 bool dependent, cudaStream_t s, Args... args) {
  return launch_grid(kernel, blocks_for(lanes), kThreads, smem, dependent, s,
                     args...);
}

// K2 over one frame with the wire's decode, which takes `smem` bytes of
// dynamic shared memory.
template <class Decode>
int launch_fused_step(const Decode& decode, int lanes, size_t smem,
                      bool dependent, const void* bloom,
                      unsigned int num_blocks, int k, void* regs,
                      int num_banks, int precision, void* counts,
                      void* valid, cudaStream_t s) {
  return launch_lanes(
      fused_step_kernel<Decode>, lanes, smem, dependent, s, decode, lanes,
      static_cast<const uint32_t*>(bloom), static_cast<uint32_t>(num_blocks),
      fastmod_magic(num_blocks), k, static_cast<uint8_t*>(regs), num_banks,
      precision, static_cast<unsigned long long*>(counts),
      static_cast<uint8_t*>(valid));
}

// K2-delta's pass 1 (delta_sums_kernel) into scratch: uint32
// tile_sums[tiles] then group_sums[ceil(tiles / 8)], tiles = ceil(lanes /
// 256); returns the DeltaDecode that reads them.
int launch_delta_sums(const uint32_t* buf, int db, int lanes,
                      int wire_banks, void* scratch, cudaStream_t s,
                      DeltaDecode* decode) {
  const int tiles = blocks_for(lanes);
  uint32_t* tile_sums = static_cast<uint32_t*>(scratch);
  uint32_t* group_sums = tile_sums + tiles;
  delta_sums_kernel<<<(tiles + kGroupTiles - 1) / kGroupTiles, kThreads, 0,
                      s>>>(buf + 2 * static_cast<size_t>(wire_banks), db,
                           lanes, tiles, tile_sums, group_sums);
  *decode = DeltaDecode{buf, wire_banks, db, lanes, tile_sums, group_sums};
  return static_cast<int>(cudaGetLastError());
}

// K3 and K11: with scratch null one thread per key, else the binned path
// (the memset and three kernels on one stream, see above) over tiles of
// the slice sk names (the whole filter for K3).
int launch_bloom_add(uint32_t* words, const SliceKeys& sk, int n, int k,
                     int log2_bpt, int chunk, uint32_t* scratch,
                     cudaStream_t s) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (scratch == nullptr) {
    bloom_add_keys_kernel<<<blocks_for(n), kThreads, 0, s>>>(words, sk, n,
                                                             k);
    return static_cast<int>(cudaGetLastError());
  }
  const int tiles = static_cast<int>(
      (sk.slice_blocks + (1u << log2_bpt) - 1u) >> log2_bpt);
  const int ctas = (n + chunk - 1) / chunk;
  uint32_t* totals = scratch;
  uint32_t* starts = totals + tiles;
  uint32_t* counts = starts + tiles + 1;
  uint32_t* offsets = counts + static_cast<size_t>(ctas) * tiles;
  uint32_t* payload = offsets + static_cast<size_t>(ctas) * tiles;
  const size_t tile_bytes = sizeof(uint32_t) * static_cast<size_t>(tiles);
  cudaError_t err = cudaMemsetAsync(totals, 0, tile_bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  bloom_tile_count_kernel<<<ctas, kThreads, tile_bytes, s>>>(
      sk, n, chunk, log2_bpt, tiles, totals, counts, offsets);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t scatter_bytes =
      sizeof(uint32_t) * (3 * static_cast<size_t>(tiles) + 2 + chunk);
  if (scatter_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(bloom_tile_scatter_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(scatter_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  bloom_tile_scatter_kernel<<<ctas, kThreads, scatter_bytes, s>>>(
      sk, n, chunk, log2_bpt, tiles, totals, counts, offsets, starts,
      payload);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bloom_tile_or_kernel<<<tiles, kThreads, size_t{64} << log2_bpt, s>>>(
      words, sk.slice_blocks, log2_bpt, k, starts, payload);
  return static_cast<int>(cudaGetLastError());
}

// A launch of `grid` CTAs of `threads` threads with `smem` bytes of dynamic
// shared memory, through cudaLaunchKernelEx with up to two attributes.
struct Launch {
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg;

  Launch(int grid, int threads, size_t smem, cudaStream_t s)
      : attr{}, cfg{} {
    cfg.gridDim = dim3(static_cast<unsigned int>(grid));
    cfg.blockDim = dim3(static_cast<unsigned int>(threads));
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 0;
  }

  // The CTAs in clusters of `size`.
  void cluster(int size) {
    cudaLaunchAttribute& a = attr[cfg.numAttrs++];
    a.id = cudaLaunchAttributeClusterDimension;
    a.val.clusterDim.x = static_cast<unsigned int>(size);
    a.val.clusterDim.y = 1;
    a.val.clusterDim.z = 1;
  }

  // A programmatic dependent of the kernel before it on the stream: its
  // CTAs may start while that kernel runs (griddepcontrol.wait orders them).
  void dependent() {
    cudaLaunchAttribute& a = attr[cfg.numAttrs++];
    a.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    a.val.programmaticStreamSerializationAllowed = 1;
  }
};

// K8's image path: the pack pass into `image`, then, as its programmatic
// dependent, K4 on the image (blocked) or the shared-memory probe (flat)
// over as many CTAs as the keys and the resident clusters allow.
int launch_contains_image(const uint8_t* bits, uint32_t m_bits, bool blocked,
                          int k, const uint32_t* keys, int n, uint8_t* out,
                          uint32_t* image, cudaStream_t s) {
  const uint32_t words = m_bits / 32u;
  bloom_pack_bytes_kernel<<<(words + kThreads - 1) / kThreads, kThreads, 0,
                            s>>>(reinterpret_cast<const uint4*>(bits), words,
                                 image);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocked) {
    const uint32_t num_blocks = m_bits / kBlockBits;
    Launch launch(blocks_for(n), kThreads, 0, s);
    launch.dependent();
    err = cudaLaunchKernelEx(&launch.cfg, bloom_contains_kernel,
                             static_cast<const uint32_t*>(image), num_blocks,
                             fastmod_magic(num_blocks), k, keys, n, out);
  } else {
    const size_t smem = sizeof(uint32_t) * words;
    err = cudaFuncSetAttribute(bloom_contains_image_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    Launch launch(kImageCluster, kImageThreads, smem, s);
    launch.cluster(kImageCluster);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters,
                                         bloom_contains_image_kernel,
                                         &launch.cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int per_cluster = kImageMinKeysPerCta * kImageCluster;
    const int wanted = (n + per_cluster - 1) / per_cluster;
    // clusters == 0 (none fits) is left to the launch to refuse.
    launch.cfg.gridDim = dim3(static_cast<unsigned int>(
        kImageCluster * max(1, min(wanted, clusters))));
    launch.dependent();
    err = cudaLaunchKernelEx(&launch.cfg, bloom_contains_image_kernel,
                             reinterpret_cast<const uint8_t*>(image),
                             static_cast<uint32_t>(smem), m_bits,
                             fastmod_magic(m_bits), k, keys, n, out);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K7's image path: pass 1 over `parts` CTAs (fewer for a short batch),
// then the merge as its programmatic dependent.
template <bool kBlocked>
int launch_add_image(uint8_t* bits, uint32_t m_bits, uint32_t d, int k,
                     const uint32_t* keys, const uint8_t* mask, int n,
                     int parts, uint4* partials, cudaStream_t s) {
  const uint32_t words = m_bits / 32u;
  const size_t smem = sizeof(uint32_t) * words;
  const int grid = max(1, min(parts, (n + kImageMinKeysPerCta - 1) /
                                         kImageMinKeysPerCta));
  cudaError_t err = cudaFuncSetAttribute(
      bloom_add_partial_kernel<kBlocked>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bloom_add_partial_kernel<kBlocked><<<grid, kImageThreads, smem, s>>>(
      words, d, fastmod_magic(d), k, keys, mask, n, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nvec = static_cast<int>(words / 4u);
  Launch launch(blocks_for(8 * nvec), kThreads, 0, s);
  launch.dependent();
  err = cudaLaunchKernelEx(&launch.cfg, bloom_merge_partials_kernel, bits,
                           nvec, static_cast<const uint4*>(partials), grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The K12 kernels read a header of at most kSmallHeader banks from
// registers (SmallHeader), a longer one from shared memory.
constexpr int kSmallHeader = 32;

// K12-seg over `lanes` lanes in CTAs of T threads, L lanes a thread, the
// header read as its length allows.
template <int T, int L>
int launch_decode_seg(const uint32_t* buf, int kb, int lanes, int wire_banks,
                      uint32_t* keys, int32_t* bank, cudaStream_t s) {
  const int ctas = (lanes + T * L - 1) / (T * L);
  if (wire_banks <= kSmallHeader) {
    return launch_grid(decode_seg_kernel<T, L, SmallHeader>, ctas, T, 0,
                       false, s, buf, wire_banks, kb, lanes, keys, bank);
  }
  return launch_grid(decode_seg_kernel<T, L, SharedHeader>, ctas, T,
                     counts_smem(wire_banks), false, s, buf, wire_banks, kb,
                     lanes, keys, bank);
}

// K12-delta's look-back, likewise.
template <int T, int L>
int launch_decode_delta(const uint32_t* buf, int db, int lanes,
                        int wire_banks, uint32_t* state, uint32_t* keys,
                        int32_t* bank, cudaStream_t s) {
  const int ctas = (lanes + T * L - 1) / (T * L);
  if (wire_banks <= kSmallHeader) {
    return launch_grid(decode_delta_scan_kernel<T, L, SmallHeader>, ctas, T,
                       0, false, s, buf, wire_banks, db, lanes, keys, bank,
                       LookbackCarry{state});
  }
  return launch_grid(decode_delta_scan_kernel<T, L, SharedHeader>, ctas, T,
                     counts_smem(wire_banks), false, s, buf, wire_banks, db,
                     lanes, keys, bank, LookbackCarry{state});
}

extern "C" {

int atp_hll_histogram(const void* regs, void* out, int num_banks, int m,
                      int num_bins, void* stream) {
  return launch_histogram(regs, num_banks, m, nullptr, num_banks, num_bins,
                          out, static_cast<cudaStream_t>(stream));
}

// K1-rows: out[b] is the histogram of bank rows[b] of regs[num_banks, m].
int atp_hll_histogram_rows(const void* regs, int num_banks, int m,
                           const void* rows, int num_rows, int num_bins,
                           void* out, void* stream) {
  return launch_histogram(regs, num_banks, m,
                          static_cast<const int32_t*>(rows), num_rows,
                          num_bins, out, static_cast<cudaStream_t>(stream));
}

// K1-union: out[num_bins] (zeroed here, then added to by every CTA) is
// the histogram of the register max over banks rows[0 .. num_rows).
int atp_hll_union_histogram(const void* regs, int num_banks, int m,
                            const void* rows, int num_rows, int num_bins,
                            void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(int32_t) * static_cast<size_t>(num_bins), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_rows > 0) {
    const int nvec = m / 16;
    hll_union_histogram_kernel<<<(nvec + kUnionLanes - 1) / kUnionLanes,
                                 kThreads, 0, s>>>(
        static_cast<const uint8_t*>(regs), num_banks, m,
        static_cast<const int32_t*>(rows), num_rows, num_bins,
        static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

int atp_fused_step(const void* wire, int bank_bytes, int key_bits, int lanes,
                   const void* bloom, unsigned int num_blocks, int k,
                   void* regs, int num_banks, int precision, void* counts,
                   void* valid, void* stream) {
  if (lanes > 0) {
    return launch_fused_step(
        WireDecode{static_cast<const uint8_t*>(wire), bank_bytes, key_bits,
                   lanes},
        lanes, 0, false, bloom, num_blocks, k, regs, num_banks, precision,
        counts, valid, static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

// K2-seg: buf is [counts u32[wire_banks] | kb-bit keys | guard] for
// `lanes` (padded) lanes; num_banks is the register rows. One launch.
int atp_fused_step_seg(const void* buf, int kb, int lanes, int wire_banks,
                       const void* bloom, unsigned int num_blocks, int k,
                       void* regs, int num_banks, int precision, void* counts,
                       void* valid, void* stream) {
  return launch_fused_step(
      SegDecode{static_cast<const uint32_t*>(buf), wire_banks, kb, lanes},
      lanes, counts_smem(wire_banks), false, bloom, num_blocks, k, regs,
      num_banks, precision, counts, valid, static_cast<cudaStream_t>(stream));
}

// K2-delta: buf is [counts | bases u32[wire_banks] | db-bit deltas |
// guard]; scratch holds uint32 tile_sums[tiles] then group_sums[ceil(tiles
// / 8)], tiles = ceil(lanes / 256), which pass 1 writes whole on every
// call. Two launches: pass 1, then the step as its programmatic
// dependent.
int atp_fused_step_delta(const void* buf, int db, int lanes, int wire_banks,
                         void* scratch, const void* bloom,
                         unsigned int num_blocks, int k, void* regs,
                         int num_banks, int precision, void* counts,
                         void* valid, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  DeltaDecode decode;
  const int err = launch_delta_sums(static_cast<const uint32_t*>(buf), db,
                                    lanes, wire_banks, scratch, s, &decode);
  if (err != 0) return err;
  return launch_fused_step(decode, lanes, counts_smem(wire_banks), true,
                           bloom, num_blocks, k, regs, num_banks, precision,
                           counts, valid, s);
}

// K12-seg: keys and bank int32[lanes] of the seg wire (K2-seg's buf), in
// one launch of CTAs of 256 threads, `lpt` (2 or 4) lanes a thread.
int atp_decode_seg(const void* buf, int kb, int lanes, int wire_banks,
                   int lpt, void* keys, void* bank, void* stream) {
  const uint32_t* b = static_cast<const uint32_t*>(buf);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* k = static_cast<uint32_t*>(keys);
  int32_t* bk = static_cast<int32_t*>(bank);
  if (lpt == 2) {
    return launch_decode_seg<256, 2>(b, kb, lanes, wire_banks, k, bk, s);
  }
  if (lpt == 4) {
    return launch_decode_seg<256, 4>(b, kb, lanes, wire_banks, k, bk, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K12-delta: the same for the delta wire (K2-delta's buf). lookback == 0,
// the two-pass design: K2-delta's pass 1 into scratch (its sums), then the
// decode as its programmatic dependent. lookback != 0: one launch of CTAs
// of 256 threads, 4 lanes a thread, over the look-back's scratch (uint32
// state[4], then 32 bytes of status a CTA), which the caller zeroes once
// and keeps (no memset between calls).
int atp_decode_delta(const void* buf, int db, int lanes, int wire_banks,
                     int lookback, void* scratch, void* keys, void* bank,
                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* b = static_cast<const uint32_t*>(buf);
  uint32_t* k = static_cast<uint32_t*>(keys);
  int32_t* bk = static_cast<int32_t*>(bank);
  if (lookback) {
    return launch_decode_delta<256, 4>(b, db, lanes, wire_banks,
                                       static_cast<uint32_t*>(scratch), k, bk,
                                       s);
  }
  DeltaDecode decode;
  const int err =
      launch_delta_sums(b, db, lanes, wire_banks, scratch, s, &decode);
  if (err != 0) return err;
  return launch_lanes(decode_lanes_kernel<DeltaDecode>, lanes,
                      counts_smem(wire_banks), true, s, decode, lanes, k, bk);
}

// scratch == nullptr: one thread per key; else the binned passes.
int atp_bloom_add(void* words, const void* keys, int n,
                  unsigned int num_blocks, int k, int log2_bpt, int chunk,
                  void* scratch, void* stream) {
  return launch_bloom_add(
      static_cast<uint32_t*>(words),
      SliceKeys{static_cast<const uint32_t*>(keys), nullptr, 0u, num_blocks,
                num_blocks, fastmod_magic(num_blocks)},
      n, k, log2_bpt, chunk, static_cast<uint32_t*>(scratch),
      static_cast<cudaStream_t>(stream));
}

// K7: blocked != 0 selects the blocked layout, else flat. mask may be
// null (every key is added). scratch == null: the direct path (one thread
// per key); else the image path with scratch uint32[parts * m_bits / 32]
// for the partial images.
int atp_bloom_add_bytes(void* bits, unsigned int m_bits, int k, int blocked,
                        const void* keys, const void* mask, int n, int parts,
                        void* scratch, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* b = static_cast<uint8_t*>(bits);
  const uint32_t* kk = static_cast<const uint32_t*>(keys);
  const uint8_t* mm = static_cast<const uint8_t*>(mask);
  const uint32_t d = blocked ? m_bits / kBlockBits : m_bits;
  if (scratch != nullptr) {
    uint4* partials = static_cast<uint4*>(scratch);
    return blocked ? launch_add_image<true>(b, m_bits, d, k, kk, mm, n,
                                            parts, partials, s)
                   : launch_add_image<false>(b, m_bits, d, k, kk, mm, n,
                                             parts, partials, s);
  }
  if (blocked) {
    bloom_add_bytes_kernel<true><<<blocks_for(n), kThreads, 0, s>>>(
        b, d, fastmod_magic(d), k, kk, mm, n);
  } else {
    bloom_add_bytes_kernel<false><<<blocks_for(n), kThreads, 0, s>>>(
        b, d, fastmod_magic(d), k, kk, mm, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// K8: out[n] is 1 where every probe byte of keys[i] is 1. image == null:
// the direct path; else the image path, with image uint32[m_bits / 32] as
// the pack pass's scratch.
int atp_bloom_contains_bytes(const void* bits, unsigned int m_bits, int k,
                             int blocked, const void* keys, int n, void* out,
                             void* image, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* b = static_cast<const uint8_t*>(bits);
  const uint32_t* kk = static_cast<const uint32_t*>(keys);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (image != nullptr) {
    return launch_contains_image(b, m_bits, blocked != 0, k, kk, n, o,
                                 static_cast<uint32_t*>(image), s);
  }
  const uint32_t d = blocked ? m_bits / kBlockBits : m_bits;
  const int grid = (n + kDirectThreads - 1) / kDirectThreads;
  if (blocked) {
    bloom_contains_bytes_kernel<true><<<grid, kDirectThreads, 0, s>>>(
        b, d, fastmod_magic(d), k, kk, n, o);
  } else {
    bloom_contains_bytes_kernel<false><<<grid, kDirectThreads, 0, s>>>(
        b, d, fastmod_magic(d), k, kk, n, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// K8's pack pass alone: image[m_bits / 32] from bits[m_bits].
int atp_bloom_pack_bytes(const void* bits, unsigned int m_bits, void* image,
                         void* stream) {
  const uint32_t words = m_bits / 32u;
  if (words > 0) {
    bloom_pack_bytes_kernel<<<(words + kThreads - 1) / kThreads, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(bits), words, static_cast<uint32_t*>(image));
  }
  return static_cast<int>(cudaGetLastError());
}

int atp_bloom_contains(const void* words, unsigned int num_blocks, int k,
                       const void* keys, int n, void* out, void* stream) {
  if (n > 0) {
    bloom_contains_kernel<<<blocks_for(n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), num_blocks,
        fastmod_magic(num_blocks), k, static_cast<const uint32_t*>(keys), n,
        static_cast<uint8_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

int atp_hll_add(void* regs, int num_banks, int precision, const void* bank,
                const void* keys, const void* valid, int n, void* stream) {
  if (n > 0) {
    hll_add_kernel<<<blocks_for(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint8_t*>(regs), num_banks, precision,
        static_cast<const int32_t*>(bank), static_cast<const uint32_t*>(keys),
        static_cast<const uint8_t*>(valid), n);
  }
  return static_cast<int>(cudaGetLastError());
}

// K9: first_word and slice_words are whole 16-word blocks of a filter of
// num_blocks blocks; key_bits > 0 reads `keys` as the word wire; compact
// != 0 takes the compact path, else the direct one.
int atp_bloom_contains_slice(const void* words, unsigned int first_word,
                             unsigned int slice_words, unsigned int num_blocks,
                             int k, const void* keys, int key_bits, int n,
                             void* out, int compact, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* w = static_cast<const uint32_t*>(words);
  const uint32_t* kk = static_cast<const uint32_t*>(keys);
  uint8_t* o = static_cast<uint8_t*>(out);
  const uint64_t magic = fastmod_magic(num_blocks);
  if (compact) {
    bloom_contains_slice_compact_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        w, first_word / 16u, slice_words / 16u, num_blocks, magic, k, kk,
        key_bits, n, o);
  } else {
    bloom_contains_slice_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        w, first_word / 16u, slice_words / 16u, num_blocks, magic, k, kk,
        key_bits, n, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// K10: regs is uint8[num_banks, regs_local], the registers [lo, lo +
// regs_local) of every bank; bank is ignored (may be null) when key_bits >
// 0; counts may be null.
int atp_hll_add_slice(void* regs, int num_banks, int precision,
                      unsigned int lo, int regs_local, const void* keys,
                      const void* bank, int key_bits, const void* valid,
                      int n, int n_real, void* counts, void* stream) {
  if (n > 0) {
    hll_add_slice_kernel<<<blocks_for(n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint8_t*>(regs), num_banks, precision, lo,
        static_cast<uint32_t>(regs_local), static_cast<const uint32_t*>(keys),
        static_cast<const int32_t*>(bank), key_bits,
        static_cast<const uint8_t*>(valid), n, n_real,
        static_cast<unsigned long long*>(counts));
  }
  return static_cast<int>(cudaGetLastError());
}

// K11: K3 on the slice words[slice_words] that starts at word first_word
// of a filter of num_blocks blocks; mask may be null. scratch == nullptr:
// one thread per key; else the binned passes over the slice's tiles.
int atp_bloom_add_slice(void* words, unsigned int first_word,
                        unsigned int slice_words, unsigned int num_blocks,
                        int k, const void* keys, const void* mask, int n,
                        int log2_bpt, int chunk, void* scratch,
                        void* stream) {
  return launch_bloom_add(
      static_cast<uint32_t*>(words),
      SliceKeys{static_cast<const uint32_t*>(keys),
                static_cast<const uint8_t*>(mask), first_word / 16u,
                slice_words / 16u, num_blocks, fastmod_magic(num_blocks)},
      n, k, log2_bpt, chunk, static_cast<uint32_t*>(scratch),
      static_cast<cudaStream_t>(stream));
}

int atp_cms_step(void* counts, int depth, unsigned int width,
                 const void* keys, const void* mask, int n, void* est,
                 void* stream) {
  if (n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cms_update_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<uint32_t*>(counts), depth, width,
        static_cast<const uint32_t*>(keys),
        static_cast<const uint8_t*>(mask), n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cms_query_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const uint32_t*>(counts), depth, width,
        static_cast<const uint32_t*>(keys),
        static_cast<const uint8_t*>(mask), n, static_cast<uint32_t*>(est));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Polyphonic voice mix for Hopper (sm_90a): SampleMulti's hot loop.
//
// Replaces the Pallas TPU kernel termdaw_tpu/ops/pallas_voices.py
// `_voice_mix_kernel` (called by `_pallas_one_call` through
// `sample_multi_pallas_stereo` for fused groups and `sample_multi_pallas`
// for a single vertex). It computes, for block k < nb and frame i < bl,
//
//     out[k*bl + i, c] = sum_{p < P} amp_c[k, p] * padded[c, begins[k, p] + i]
//
// with the voices accumulated in slot order as `out + window * amp`.
//
// What bounds it on this card. At the c5 shapes (nb = 375 blocks of
// bl = 1024 frames per window, P = 16 slots) a window writes 3 MB, about
// a microsecond of the card's 3.35 TB/s: that is the bound (bytes read
// once and written once). But every slot of every frame reads both
// channels, 375 * 1024 * 16 * 2 floats (49 MB) from a padded buffer of a
// few tens of KB, so the kernel's time is set by how those reads are
// issued. The first kernel (one thread a frame, a CTA a 256-frame tile)
// paid, for every frame and slot, a read of the slot's table entry, a
// clamp and two loads through L1 and L2, with one frame of work between
// them.
//
// Design: a warp mixes a (block, 256-frame tile) work item; lane l
// the frames l, l + 32, ... l + 224, both channels. A slot's table entry
// and base address serve 8 frames a lane, and its 16 loads (8 frames x 2
// channels) are independent and in flight together; the 16 sums stay in
// registers. A warp stages its item's slot table in its own 32-entry part
// of shared memory (Hopper has no scalar prefetch), read as one broadcast
// a slot, and loads its next item's first 32 entries while it mixes. A
// CTA has as few warps as spread the items over the SMs in one round
// (kernels.voice_mix_plan); neighbouring lanes read neighbouring floats.
// The plan picks one of two regimes by the buffer's size alone:
//
// * Resident, when the [2, lpad] buffer fits about 200 KB (lpad up to
//   25,598 frames; every buffer of the render paths): each CTA first
//   copies the whole buffer into dynamic shared memory (float4 loads on
//   neighbouring threads, 4 in flight a thread; the unaligned head and
//   tail as floats), then reads the windows there, conflict-free. A TMA
//   bulk copy (cp.async.bulk on an mbarrier) staged the buffer more
//   slowly than these loads on the card, so it went.
// * Streamed, for a larger buffer (a long user sample: 30 s at 48 kHz is
//   11.5 MB): the same walk, reading the windows from global memory.
//
// The multiply and the add are separate round-to-nearest operations
// (__fmul_rn/__fadd_rn): nvcc would otherwise contract them into an FMA
// and lose the reference's rounding, so both regimes are bit-exact to
// the plain version. The TPU-specific parts of the Pallas kernel
// (128-lane-aligned superset DMA plus roll, the SMEM budget split,
// double-buffered DMA semaphores) have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;               // frames of one work item
constexpr int kLaneFrames = kTile / 32;  // frames a lane mixes
constexpr int kWarpSlots = 32;           // slots a warp stages at once
constexpr int kMaxWarps = 32;            // warps of the largest CTA
constexpr int kStageDepth = 4;  // staged: float4 loads in flight a thread

// One slot of a block's table.
struct __align__(16) Slot {
  int begin;
  float al, ar, pad;
};

__device__ __forceinline__ Slot load_slot(const int* __restrict__ begins,
                                          const float* __restrict__ amp_l,
                                          const float* __restrict__ amp_r,
                                          long long at) {
  return {__ldg(begins + at), __ldg(amp_l + at), __ldg(amp_r + at), 0.0f};
}

// Copies padded[0, n) into buf[0, n) in shared memory with all the
// CTA's threads. buf sits as far past a 16-byte boundary as padded does,
// so the 16-byte-aligned middle goes as float4 loads on neighbouring
// threads, kStageDepth of them in flight a thread, and the head and tail
// (at most 3 floats each) as floats.
__device__ __forceinline__ void stage_buffer(const float* __restrict__ padded,
                                             float* buf, int n) {
  const int o = (int)((reinterpret_cast<uintptr_t>(padded) & 15) >> 2);
  const int h = min((4 - o) & 3, n);
  const int nv = (n - h) >> 2;  // float4s of the middle
  const float4* g4 = reinterpret_cast<const float4*>(padded + h);
  float4* s4 = reinterpret_cast<float4*>(buf + h);
  const int step = blockDim.x;
  int q = threadIdx.x;
  for (; q + (kStageDepth - 1) * step < nv; q += kStageDepth * step) {
    float4 r[kStageDepth];
#pragma unroll
    for (int u = 0; u < kStageDepth; ++u) r[u] = __ldg(g4 + q + u * step);
#pragma unroll
    for (int u = 0; u < kStageDepth; ++u) s4[q + u * step] = r[u];
  }
  for (; q < nv; q += step) s4[q] = __ldg(g4 + q);
  for (int i = threadIdx.x; i < h; i += step) buf[i] = padded[i];
  for (int i = h + 4 * nv + threadIdx.x; i < n; i += step)
    buf[i] = padded[i];
  __syncthreads();
}

// Adds slots tab[0..n) to the lane's sums acc_l/acc_r[f] of frames
// i0 + 32f, reading the channel rows left and right (lpad frames each,
// shared or global memory). Unclamped, the slots' windows at i0 lie in
// the buffer, so each slot's 16 loads take one base address and fixed
// offsets; clamped, each frame's index is clamped into the buffer.
template <bool kClamp>
__device__ __forceinline__ void mix_chunk(const Slot* tab, int n,
                                          const float* left,
                                          const float* right, long long lpad,
                                          int i0, float (&acc_l)[kLaneFrames],
                                          float (&acc_r)[kLaneFrames]) {
#pragma unroll 2
  for (int j = 0; j < n; ++j) {
    const Slot v = tab[j];
    const long long b = (long long)v.begin + i0;
    float wl[kLaneFrames], wr[kLaneFrames];
#pragma unroll
    for (int f = 0; f < kLaneFrames; ++f) {
      const long long c =
          kClamp ? min(max(b + 32 * f, 0LL), lpad - 1) : b + 32 * f;
      wl[f] = left[c];
      wr[f] = right[c];
    }
#pragma unroll
    for (int f = 0; f < kLaneFrames; ++f) {
      acc_l[f] = __fadd_rn(acc_l[f], __fmul_rn(wl[f], v.al));
      acc_r[f] = __fadd_rn(acc_r[f], __fmul_rn(wr[f], v.ar));
    }
  }
}

// Each warp mixes the work items warp, warp + (warps of the grid), ...
// (item w = block w / tiles, frame tile w % tiles): lane l the frames l,
// l + 32, ... l + 224 of the tile, both channels, each slot's window
// read at a base of begin + l and fixed offsets. Staged, the buffer is
// first copied into shared memory and read there; else it is read from
// global memory. A warp stages its item's slot table in its own part of
// shared memory, 32 slots at a time, and loads the first 32 of its next
// item's while it mixes; one vote a chunk tells whether its windows need
// clamping. The sums run in slot order, the multiply and the add rounded
// separately.
template <bool kStaged>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
voice_mix_kernel(const float* __restrict__ padded, long long lpad,
                 const int* __restrict__ begins,
                 const float* __restrict__ amp_l,
                 const float* __restrict__ amp_r, int nb, int P, int bl,
                 float* __restrict__ out) {
  extern __shared__ float4 sm4[];
  __shared__ Slot s_slot[kMaxWarps][kWarpSlots];
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int tiles = (bl + kTile - 1) / kTile;
  const long long items = (long long)nb * tiles;
  const long long stride = (long long)gridDim.x * warps;
  long long w = (long long)blockIdx.x * warps + (threadIdx.x >> 5);
  // this lane's slot of the first chunk of its warp's next item
  Slot next{0, 0.0f, 0.0f, 0.0f};
  if (w < items && lane < P)
    next = load_slot(begins, amp_l, amp_r, w / tiles * P + lane);
  const float* left = padded;
  if (kStaged) {
    float* buf = reinterpret_cast<float*>(sm4) +
                 ((reinterpret_cast<uintptr_t>(padded) & 15) >> 2);
    stage_buffer(padded, buf, (int)(2 * lpad));
    left = buf;
  }
  const float* right = left + lpad;
  Slot* tab = s_slot[threadIdx.x >> 5];
  for (; w < items; w += stride) {  // the same trip count on every lane
    const int k = (int)(w / tiles);
    const int i0 = (int)(w % tiles) * kTile + lane;  // this lane's frame 0
    const long long row = (long long)k * P;
    float acc_l[kLaneFrames], acc_r[kLaneFrames];
#pragma unroll
    for (int f = 0; f < kLaneFrames; ++f) acc_l[f] = acc_r[f] = 0.0f;
    for (int p0 = 0; p0 < P; p0 += kWarpSlots) {
      const int n = min(kWarpSlots, P - p0);
      __syncwarp();  // the previous chunk is read
      Slot mine = next;  // this lane's slot of the chunk
      if (p0 == 0) {
        if (w + stride < items && lane < P)
          next = load_slot(begins, amp_l, amp_r,
                           (w + stride) / tiles * P + lane);
      } else if (lane < n) {
        mine = load_slot(begins, amp_l, amp_r, row + p0 + lane);
      }
      tab[lane] = mine;
      // does every slot's window over the tile lie in the buffer? (always
      // with make_padded_sample's layout and the bake's begins; not for a
      // ragged last tile near the end of a tighter buffer, or a bad table)
      const long long ws = (long long)mine.begin + (i0 - lane);
      const bool fits = lane >= n || (ws >= 0 && ws + kTile <= lpad);
      const bool all_fit = __all_sync(0xffffffffu, fits);
      __syncwarp();
      if (all_fit)
        mix_chunk<false>(tab, n, left, right, lpad, i0, acc_l, acc_r);
      else
        mix_chunk<true>(tab, n, left, right, lpad, i0, acc_l, acc_r);
    }
    float2* o = reinterpret_cast<float2*>(out) + (long long)k * bl;
#pragma unroll
    for (int f = 0; f < kLaneFrames; ++f)
      if (i0 + 32 * f < bl) o[i0 + 32 * f] = make_float2(acc_l[f], acc_r[f]);
  }
}

}  // namespace

// padded [2, lpad] f32 (lpad >= 256), begins/amp_l/amp_r [nb, P],
// out [nb*bl, 2] f32, all contiguous device memory. The plan
// (kernels.voice_mix_plan): `grid` CTAs of `threads` threads (a multiple
// of 32, at most 1024); staged != 0 copies the buffer into smem bytes of
// dynamic shared memory (at least 8 * lpad + 16) first. Launches on
// `stream` and returns the first CUDA error (0 on success); does not
// synchronise.
extern "C" int voice_mix_stereo_launch(const float* padded, long long lpad,
                                       const int* begins, const float* amp_l,
                                       const float* amp_r, int nb, int P,
                                       int bl, float* out, int staged,
                                       int grid, int threads, int smem,
                                       void* stream) {
  if (nb <= 0 || bl <= 0) return 0;
  if (grid < 1 || threads < 32 || threads % 32 ||
      threads > kMaxWarps * 32 || lpad < kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (staged) {
    if (lpad > (1 << 28) || (long long)smem < 8 * lpad + 16)
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = cudaFuncSetAttribute(
        voice_mix_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    voice_mix_kernel<true><<<grid, threads, smem, st>>>(
        padded, lpad, begins, amp_l, amp_r, nb, P, bl, out);
  } else {
    voice_mix_kernel<false><<<grid, threads, 0, st>>>(
        padded, lpad, begins, amp_l, amp_r, nb, P, bl, out);
  }
  return static_cast<int>(cudaGetLastError());
}

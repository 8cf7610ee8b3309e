// Fused masked cross-entropy with label smoothing, forward and backward, for
// the H100 (sm_90a), each with a plain C launcher (loaded through ctypes by
// ops/cuda_build.py, called by ops/fused_loss.py).
//
// They replace the Pallas kernels of the JAX package's ops/fused_loss.py:
//   fused_ce_fwd_sm90  <-  _fwd_kernel  (ops/fused_loss.py:47)
//   fused_ce_bwd_sm90  <-  _bwd_kernel  (ops/fused_loss.py:72)
//
// Semantics (those of engine.losses.cross_entropy without sample weights):
// masked columns hold NEG_INF (a large negative finite value); the smoothing
// target is (1-s)*onehot + s/num_active over the active columns; per-row
// loss (1-s)*nll + s*(lse - mean of the active logits).
//
// Bound.  A row-wise reduction and one elementwise pass, with no matrix
// product.  At the train step's shape (B=128, W=100, f32) the forward reads
// 51,200 bytes of logits and 1 KB of labels and writes 1 KB; the backward
// reads the logits and writes as many bytes of gradient.  Over the H100
// SXM's 3.35 TB/s that is 16 ns and 31 ns: bytes set no kernel's time at
// this size, the fixed cost of a launch and of a block does.  So the design
// cuts launches and per-launch work:
//   - One launch per direction.  The forward also writes the 0-d result
//     scale * sum(per) (the batch mean, or a rank's share of the global
//     mean): each block writes its partial sum to a scratch slot, and the
//     last block to take a ticket (__threadfence + atomicAdd) adds the
//     partials in block order, writes the result and resets the ticket to 0.
//     No float atomics, so the loss is bitwise the same from run to run.
//   - A warp per row, kRowsPerBlock rows a block (B=128 gives 32 blocks).
//     The row is read once into registers, with 16-byte loads where the
//     base pointer and the row stride allow and narrower ones otherwise;
//     max, sum of exponentials and the active-column sum are warp shuffles.
//   - Rows wider than the registers hold (kMaxRegWidth) stream through an
//     online logsumexp, chunk by chunk, as the Triton kernel did.
//   - num_active, the labels and the upstream gradient are read through
//     pointers: the train step never waits on the host.
//
// Launch counts.  Thread 0 of block 0 of every launch adds 1 to a 64-bit
// counter in device memory (`launches`, one for each kernel), so a run can
// show how often a kernel ran on the card, also when it ran as a node of a
// replayed CUDA graph, where the host-side launcher is called only once, at
// the capture.
//
// Why no wgmma, TMA or mbarriers: wgmma needs a matrix product and there is
// none; TMA and mbarriers stage tiles through shared memory, while here each
// value is used by the one thread that loads it, and the whole input is
// ~51 KB.
//
// Numerics: expf/logf (not the __expf intrinsics; built without fast math)
// and f32 accumulation for f32 and bf16 logits.  Lanes past W load as -inf,
// never 0, so they add nothing to the sums.  exp(NEG_INF - m) is exactly 0 in
// f32, so masked columns get exactly 0 gradient.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 4;                  // warps a block, a row each
constexpr int kRegCols = 32;                      // columns a lane holds
constexpr int kMaxRegWidth = kWarp * kRegCols;    // wider rows stream
constexpr unsigned kFullMask = 0xffffffffu;

enum DType { kF32 = 0, kBF16 = 1 };

// Element types: the raw storage type and its conversions to and from f32.
struct F32 {
  using Raw = float;
  __device__ static float load(Raw r) { return r; }
  __device__ static Raw store(float f) { return f; }
};

struct BF16 {
  using Raw = unsigned short;
  __device__ static float load(Raw r) {
    return __uint_as_float(static_cast<unsigned>(r) << 16);
  }
  __device__ static Raw store(float f) {  // round to nearest even, as torch
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};

// One load or store of `Bytes` bytes.
template <int Bytes> struct Pod;
template <> struct Pod<16> { using T = uint4; };
template <> struct Pod<8> { using T = uint2; };
template <> struct Pod<4> { using T = unsigned; };
template <> struct Pod<2> { using T = unsigned short; };

template <typename E, int V>
union Pack {
  typename Pod<sizeof(typename E::Raw) * V>::T pod;
  typename E::Raw e[V];
};

// The V values of row[col, col + V) as f32; those at or past W as -inf.  A
// vector that lies inside the row is one V-element load: the launcher picks
// V so that every row start is aligned to it, and col is a multiple of V.
template <typename E, int V>
__device__ __forceinline__ void load_vec(const typename E::Raw* row, int col, int W,
                                         float (&v)[V]) {
  using P = typename Pod<sizeof(typename E::Raw) * V>::T;
  if (col + V <= W) {
    Pack<E, V> p;
    p.pod = *reinterpret_cast<const P*>(row + col);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = E::load(p.e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = col + i < W ? E::load(row[col + i]) : -INFINITY;
  }
}

template <typename E, int V>
__device__ __forceinline__ void store_vec(typename E::Raw* row, int col, int W,
                                          const float (&v)[V]) {
  using P = typename Pod<sizeof(typename E::Raw) * V>::T;
  if (col + V <= W) {
    Pack<E, V> p;
#pragma unroll
    for (int i = 0; i < V; ++i) p.e[i] = E::store(v[i]);
    *reinterpret_cast<P*>(row + col) = p.pod;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (col + i < W) row[col + i] = E::store(v[i]);
    }
  }
}

// Butterfly reductions: partners add in either order, which is the same in
// floating point, so every lane ends with the same, reproducible value.
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

struct RowStats {
  float m;   // row max
  float s;   // sum of exp(x - m)
  float a;   // sum of the active columns' logits
  float xl;  // the label's logit (0 for a label outside the row)
};

// A row of at most kMaxRegWidth columns, held in registers: up to kChunks
// passes of the warp, each lane V consecutive columns a pass.  Passes that
// start past W are skipped (the same branch for the whole warp), so a
// 100-wide f32 row costs one pass, not kChunks.
template <typename E, int V>
__device__ __forceinline__ RowStats row_stats_registers(const typename E::Raw* row, int W,
                                                        int na, long long label, int lane) {
  constexpr int kChunk = kWarp * V;
  constexpr int kChunks = kRegCols / V;
  float v[kChunks][V];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (c * kChunk < W) load_vec<E, V>(row, c * kChunk + lane * V, W, v[c]);
  }
  float m = -INFINITY;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (c * kChunk >= W) break;
#pragma unroll
    for (int i = 0; i < V; ++i) m = fmaxf(m, v[c][i]);
  }
  m = warp_max(m);
  float s = 0.f, a = 0.f, xl = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (c * kChunk >= W) break;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int col = c * kChunk + lane * V + i;
      s += expf(v[c][i] - m);
      if (col < na) a += v[c][i];
      if (col == label) xl = v[c][i];
    }
  }
  // The label's logit, from the lane that holds it.
  const bool in_row = label >= 0 && label < W;
  const int holder = in_row ? static_cast<int>(label % kChunk) / V : 0;
  xl = __shfl_sync(kFullMask, xl, holder);
  return {m, warp_sum(s), warp_sum(a), in_row ? xl : 0.f};
}

// A wider row, streamed a chunk at a time: each lane keeps an online max and
// sum of exponentials over its columns, and the warp merges them at the end.
template <typename E, int V>
__device__ __forceinline__ RowStats row_stats_streaming(const typename E::Raw* row, int W,
                                                        int na, long long label, int lane) {
  constexpr int kChunk = kWarp * V;
  float m = -INFINITY, s = 0.f, a = 0.f;
  for (int start = 0; start < W; start += kChunk) {
    const int col = start + lane * V;
    float v[V];
    load_vec<E, V>(row, col, W, v);
    float cm = v[0];
#pragma unroll
    for (int i = 1; i < V; ++i) cm = fmaxf(cm, v[i]);
    const float nm = fmaxf(m, cm);
    if (nm != -INFINITY) {  // a lane past W has nothing to add (and -inf - -inf is NaN)
      s *= expf(m - nm);
#pragma unroll
      for (int i = 0; i < V; ++i) s += expf(v[i] - nm);
      m = nm;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (col + i < na) a += v[i];
    }
  }
  const float row_m = warp_max(m);
  const float row_s = warp_sum(m == -INFINITY ? 0.f : s * expf(m - row_m));
  const bool in_row = label >= 0 && label < W;
  return {row_m, row_s, warp_sum(a), in_row ? E::load(row[label]) : 0.f};
}

template <typename E, int V>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
fused_ce_fwd_sm90(const typename E::Raw* __restrict__ x, long long B, int W, long long stride,
                  const long long* __restrict__ labels, const int* __restrict__ num_active,
                  float smoothing, float scale, float* __restrict__ per,
                  float* __restrict__ lse_out, float* __restrict__ partials,
                  unsigned* __restrict__ ticket, float* __restrict__ out,
                  unsigned long long* __restrict__ launches) {
  __shared__ float row_loss[kRowsPerBlock];
  __shared__ bool last_block;
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(launches, 1ull);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const long long r = static_cast<long long>(blockIdx.x) * kRowsPerBlock + warp;
  float loss = 0.f;
  if (r < B) {  // the same for the whole warp
    const typename E::Raw* row = x + r * stride;
    const int na = *num_active;
    const long long label = labels[r];
    const RowStats st = W <= kMaxRegWidth ? row_stats_registers<E, V>(row, W, na, label, lane)
                                          : row_stats_streaming<E, V>(row, W, na, label, lane);
    const float lse = st.m + logf(st.s);
    const float nll = lse - st.xl;
    // -mean of logp over the active columns = lse - mean of x over them.
    const float smooth = lse - st.a / static_cast<float>(na);
    loss = (1.f - smoothing) * nll + smoothing * smooth;
    if (lane == 0) {
      per[r] = loss;
      lse_out[r] = lse;
    }
  }
  if (lane == 0) row_loss[warp] = loss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kRowsPerBlock; ++w) sum += row_loss[w];
    partials[blockIdx.x] = sum;
    __threadfence();  // the partial is visible before the ticket is taken
    last_block = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last_block && warp == 0) {
    // Every partial is in; lane l adds blocks l, l + 32, ... in order.
    float sum = 0.f;
    for (unsigned b = lane; b < gridDim.x; b += kWarp) sum += __ldcg(partials + b);
    sum = warp_sum(sum);
    if (lane == 0) {
      *out = scale * sum;
      *ticket = 0;  // ready for the next launch on the stream
    }
  }
}

// dlogits = (p - ((1-s)*onehot + s/num_active on active columns)) * g * scale,
// in the logits' dtype; masked columns come out exactly 0.
template <typename E, int V>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
fused_ce_bwd_sm90(const typename E::Raw* __restrict__ x, long long B, int W, long long stride,
                  const long long* __restrict__ labels, const int* __restrict__ num_active,
                  const float* __restrict__ lse, const float* __restrict__ grad,
                  float smoothing, float scale, typename E::Raw* __restrict__ dx,
                  long long dx_stride, unsigned long long* __restrict__ launches) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(launches, 1ull);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const long long r = static_cast<long long>(blockIdx.x) * kRowsPerBlock + warp;
  if (r >= B) return;
  const typename E::Raw* row = x + r * stride;
  typename E::Raw* drow = dx + r * dx_stride;
  const int na = *num_active;
  const long long label = labels[r];
  const float row_lse = lse[r];
  const float gs = *grad * scale;
  const float on_label = 1.f - smoothing;
  const float uniform = smoothing / static_cast<float>(na);
  constexpr int kChunk = kWarp * V;
  for (int col = lane * V; col < W; col += kChunk) {
    float v[V];
    load_vec<E, V>(row, col, W, v);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = col + i;
      const float target = (c == label ? on_label : 0.f) + (c < na ? uniform : 0.f);
      v[i] = (expf(v[i] - row_lse) - target) * gs;
    }
    store_vec<E, V>(drow, col, W, v);
  }
}

// Does nothing: its device time is the least any kernel launched through
// this path costs on the card.
__global__ void fused_ce_empty_sm90() {}

// Launches on `device`, restoring the caller's current device afterwards.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      switched_ = err_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched_) cudaSetDevice(prev_);
  }
  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool switched_ = false;
  cudaError_t err_;
};

// The widest vector (in elements, at most 16 bytes) to which every row start
// of each array is aligned: a 16-byte load needs the base pointer and the
// row stride in bytes to be multiples of 16.
int vec_elems(int elem_bytes, const void* p, long long stride, const void* q,
              long long q_stride) {
  for (int v = 16 / elem_bytes; v > 1; v /= 2) {
    const long long bytes = static_cast<long long>(v) * elem_bytes;
    const bool p_ok = reinterpret_cast<uintptr_t>(p) % bytes == 0 &&
                      (stride * elem_bytes) % bytes == 0;
    const bool q_ok = q == nullptr || (reinterpret_cast<uintptr_t>(q) % bytes == 0 &&
                                       (q_stride * elem_bytes) % bytes == 0);
    if (p_ok && q_ok) return v;
  }
  return 1;
}

unsigned num_blocks(long long B) {
  return static_cast<unsigned>((B + kRowsPerBlock - 1) / kRowsPerBlock);
}

struct FwdArgs {
  const void* x;
  long long B;
  int W;
  long long stride;
  const long long* labels;
  const int* num_active;
  float smoothing, scale;
  float *per, *lse, *partials;
  unsigned* ticket;
  float* out;
  unsigned long long* launches;
  cudaStream_t stream;
};

struct BwdArgs {
  const void* x;
  long long B;
  int W;
  long long stride;
  const long long* labels;
  const int* num_active;
  const float *lse, *grad;
  float smoothing, scale;
  void* dx;
  long long dx_stride;
  unsigned long long* launches;
  cudaStream_t stream;
};

template <typename E, int V>
struct FwdLaunch {
  static cudaError_t run(const FwdArgs& a) {
    fused_ce_fwd_sm90<E, V><<<num_blocks(a.B), kWarp * kRowsPerBlock, 0, a.stream>>>(
        static_cast<const typename E::Raw*>(a.x), a.B, a.W, a.stride, a.labels, a.num_active,
        a.smoothing, a.scale, a.per, a.lse, a.partials, a.ticket, a.out, a.launches);
    return cudaGetLastError();
  }
};

template <typename E, int V>
struct BwdLaunch {
  static cudaError_t run(const BwdArgs& a) {
    fused_ce_bwd_sm90<E, V><<<num_blocks(a.B), kWarp * kRowsPerBlock, 0, a.stream>>>(
        static_cast<const typename E::Raw*>(a.x), a.B, a.W, a.stride, a.labels, a.num_active,
        a.lse, a.grad, a.smoothing, a.scale, static_cast<typename E::Raw*>(a.dx),
        a.dx_stride, a.launches);
    return cudaGetLastError();
  }
};

// The kernel instance for the dtype and vector width.
template <template <typename, int> class Launch, typename Args>
cudaError_t dispatch(int dtype, int v, const Args& a) {
  if (dtype == kF32) {
    switch (v) {
      case 4: return Launch<F32, 4>::run(a);
      case 2: return Launch<F32, 2>::run(a);
      case 1: return Launch<F32, 1>::run(a);
    }
  } else if (dtype == kBF16) {
    switch (v) {
      case 8: return Launch<BF16, 8>::run(a);
      case 4: return Launch<BF16, 4>::run(a);
      case 2: return Launch<BF16, 2>::run(a);
      case 1: return Launch<BF16, 1>::run(a);
    }
  }
  return cudaErrorInvalidValue;
}

int elem_bytes(int dtype) { return dtype == kBF16 ? 2 : 4; }

}  // namespace

// Rows one block of either kernel covers; the forward's scratch holds one
// float a block.
extern "C" int fused_ce_rows_per_block(void) { return kRowsPerBlock; }

extern "C" const char* fused_ce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// per[B], lse[B] and out = scale * sum(per) for logits [B, W] (f32 or bf16,
// row stride `stride` elements).  `partials` holds ceil(B / rows per block)
// floats of scratch; `ticket` is one zeroed unsigned int that the kernel
// leaves at 0; the kernel adds 1 to the unsigned 64-bit `launches` each time
// it runs.  Returns the launch's CUDA error code (0 on success).
extern "C" int fused_ce_fwd_launch(int device, const void* x, int dtype, long long B, int W,
                                   long long stride, const void* labels,
                                   const void* num_active, float smoothing, float scale,
                                   void* per, void* lse, void* partials, void* ticket,
                                   void* out, void* launches, void* stream) {
  if (B <= 0 || W <= 0) return cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  const FwdArgs a{x, B, W, stride,
                  static_cast<const long long*>(labels), static_cast<const int*>(num_active),
                  smoothing, scale,
                  static_cast<float*>(per), static_cast<float*>(lse),
                  static_cast<float*>(partials), static_cast<unsigned*>(ticket),
                  static_cast<float*>(out), static_cast<unsigned long long*>(launches),
                  static_cast<cudaStream_t>(stream)};
  return dispatch<FwdLaunch>(dtype, vec_elems(elem_bytes(dtype), x, stride, nullptr, 0), a);
}

// dlogits [B, W] (row stride `dx_stride`) in the logits' dtype, for the
// upstream 0-d f32 `grad` of scale * sum(per); the kernel adds 1 to the
// unsigned 64-bit `launches` each time it runs.
extern "C" int fused_ce_bwd_launch(int device, const void* x, int dtype, long long B, int W,
                                   long long stride, const void* labels,
                                   const void* num_active, const void* lse, const void* grad,
                                   float smoothing, float scale, void* dx, long long dx_stride,
                                   void* launches, void* stream) {
  if (B <= 0 || W <= 0) return cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  const BwdArgs a{x, B, W, stride,
                  static_cast<const long long*>(labels), static_cast<const int*>(num_active),
                  static_cast<const float*>(lse), static_cast<const float*>(grad),
                  smoothing, scale, dx, dx_stride, static_cast<unsigned long long*>(launches),
                  static_cast<cudaStream_t>(stream)};
  const int v = vec_elems(elem_bytes(dtype), x, stride, dx, dx_stride);
  return dispatch<BwdLaunch>(dtype, v, a);
}

// One launch of the empty kernel, through the same path.
extern "C" int fused_ce_empty_launch(int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  fused_ce_empty_sm90<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

// K3: the property DAG's particle sums, float32 or float64 in, float64 in
// registers, one rounding out (float32 or float64 from float32, float64 from
// float64).
//
// Replaces no TPU kernel.  On the TPU, XLA fuses a float32 sum accumulated
// in float64 into one pass.  In plain PyTorch on this card,
// `x.sum(dim, dtype=torch.float64).to(torch.float32)` is three launches: a
// float64 copy of x (4 bytes read and 8 written an element), a float64
// reduce (8 read) and the downcast, after a `torch.where` copy where the
// sum is masked.
//
// What bounds it on an H100: device-memory bytes, 4 an element of a float32
// input (8 of a float64 one) and 1 an element of a mask.  One float64 add an
// element is far below the card's float64 rate.
//
// Design:
//  - One warp sums one chunk of `chunk` consecutive elements of one row (the
//    reduced axis at one index of the other axes; a multiple of 128, fixed by
//    the wrapper).  A longer row is split over several warps, each writing a
//    float64 partial, and a second kernel adds a row's partials in chunk
//    order.  No atomics: every run adds the same numbers in the same order.
//  - Inside a chunk, lane l takes the quads (4 consecutive elements) l,
//    l + 32, l + 64, ... and adds their elements in order into one float64
//    register; the warp then adds its 32 lanes by shuffles.  Where a row is
//    contiguous and 16-byte aligned (and its mask contiguous and 4-byte
//    aligned) a quad is one float4 load (and one 4-byte mask load);
//    otherwise it is four element loads, strided as the row is, in the same
//    order, so both paths give the same bits.  Either way 8 quads are in
//    flight a lane; the mask is read first, and what it leaves out (a
//    bucket's padding, the rows outside a small aperture) is not read.
//    Quads and elements past the row's end read as zeros.
//  - Chunks, lanes and quads sit at fixed offsets from the row's start, so
//    zeros padded onto a row's end add +0 to an accumulator, which leaves it
//    as it was: a sum does not depend on the padded length (the bucket's
//    capacity), nor on the other rows of the call.
//  - A masked-out element adds +0, as `torch.where(mask, x, 0)` would.

#include <cuda_runtime.h>
#include <stdint.h>

// one launch, as `reductions.Launch` builds it once per layout: the rows
// are up to three coordinates (outermost first) over the axes that are
// not reduced, coordinate 0 being r / (n1 * n2); strides in elements
struct Launch {
  int device, in_f64, out_f64, warps_per_block;
  long long n1, n2;
  long long xs0, xs1, xs2, xk;  // x's: the coordinates, the reduced axis
  long long ms0, ms1, ms2, mk;  // the mask's (unused without one)
  long long n_rows, K, chunk, n_chunks;
};

namespace {

constexpr int kUnroll = 8;  // float4 quads in flight a lane

template <bool kMask>
__device__ __forceinline__ double add_quad(double acc, float4 v, uchar4 m) {
  acc += (!kMask || m.x) ? (double)v.x : 0.0;
  acc += (!kMask || m.y) ? (double)v.y : 0.0;
  acc += (!kMask || m.z) ? (double)v.z : 0.0;
  acc += (!kMask || m.w) ? (double)v.w : 0.0;
  return acc;
}

template <typename T, typename TOut, bool kMask>
__global__ void particle_sum_rows(const T* __restrict__ x, const unsigned char* __restrict__ mask,
                                  const Launch g, TOut* __restrict__ out,
                                  double* __restrict__ partial) {
  const long long n_chunks = g.n_chunks, chunk = g.chunk, K = g.K;
  const long long item = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (item >= g.n_rows * n_chunks) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const long long r = item / n_chunks;
  const long long c = item - r * n_chunks;
  const long long r2 = r % g.n2, r01 = r / g.n2;
  const long long r1 = r01 % g.n1, r0 = r01 / g.n1;
  const T* xr = x + r0 * g.xs0 + r1 * g.xs1 + r2 * g.xs2;
  const unsigned char* mr = kMask ? mask + r0 * g.ms0 + r1 * g.ms1 + r2 * g.ms2 : nullptr;
  const long long k_end = K < (c + 1) * chunk ? K : (c + 1) * chunk;
  long long q = c * (chunk / 4) + lane;  // this lane's next quad
  double acc = 0.0;

  const bool vec = sizeof(T) == 4 && g.xk == 1 && ((uintptr_t)xr & 15) == 0 &&
                   (!kMask || (g.mk == 1 && ((uintptr_t)mr & 3) == 0));
  if (vec) {
    // kUnroll quads in flight a lane, each one float4 (and one uchar4 of
    // the mask, read first: a quad with nothing selected is not read); a
    // quad past the whole ones reads as zeros, which add +0
    const float4* xv = reinterpret_cast<const float4*>(xr);
    const uchar4* mv = reinterpret_cast<const uchar4*>(mr);
    const long long q_full = k_end >> 2;  // quads wholly before k_end
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const uchar4 all = make_uchar4(1, 1, 1, 1), none = make_uchar4(0, 0, 0, 0);
    for (; q < q_full; q += 32 * kUnroll) {
      float4 v[kUnroll];
      uchar4 m[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long qu = q + 32 * u;
        m[u] = qu >= q_full ? none : kMask ? __ldg(mv + qu) : all;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        v[u] = (m[u].x | m[u].y | m[u].z | m[u].w) ? __ldg(xv + q + 32 * u) : zero;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc = add_quad<kMask>(acc, v[u], m[u]);
    }
    q -= 32 * ((q - q_full) >> 5);  // this lane's first quad not wholly before k_end
  }
  // element by element, kUnroll quads in flight a lane: every quad of a
  // strided, unaligned or float64 row, and an aligned row's last, partial
  // quad; an element past k_end, or masked out, is not read and adds +0
  for (; 4 * q < k_end; q += 32 * kUnroll) {
    bool m[kUnroll][4];
    T v[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long k = 4 * (q + 32 * u) + e;
        m[u][e] = k < k_end && (!kMask || __ldg(mr + k * g.mk));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[u][e] = m[u][e] ? __ldg(xr + (4 * (q + 32 * u) + e) * g.xk) : T(0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc += (double)v[u][e];
    }
  }

  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    if (n_chunks == 1) out[r] = (TOut)acc;
    else partial[item] = acc;
  }
}

// a split row's partials, added in chunk order, rounded once
template <typename TOut>
__global__ void particle_sum_finish(const double* __restrict__ partial, long long n_rows,
                                    long long n_chunks, TOut* __restrict__ out) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const double* p = partial + r * n_chunks;
  double acc = p[0];
  for (long long c = 1; c < n_chunks; ++c) acc += p[c];
  out[r] = (TOut)acc;
}

template <typename T, typename TOut, bool kMask>
void launch(const Launch& g, const void* x, const void* mask, void* out, void* partial,
            cudaStream_t stream) {
  const long long blocks = (g.n_rows * g.n_chunks + g.warps_per_block - 1) / g.warps_per_block;
  particle_sum_rows<T, TOut, kMask><<<(unsigned)blocks, 32 * g.warps_per_block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const unsigned char*>(mask), g,
      static_cast<TOut*>(out), static_cast<double*>(partial));
  if (g.n_chunks > 1) {
    particle_sum_finish<TOut><<<(unsigned)((g.n_rows + 255) / 256), 256, 0, stream>>>(
        static_cast<const double*>(partial), g.n_rows, g.n_chunks, static_cast<TOut*>(out));
  }
}

template <typename T, typename TOut>
void launch_masked(const Launch& g, const void* x, const void* mask, void* out, void* partial,
                   cudaStream_t stream) {
  if (mask) {
    launch<T, TOut, true>(g, x, mask, out, partial, stream);
  } else {
    launch<T, TOut, false>(g, x, mask, out, partial, stream);
  }
}

}  // namespace

// x: float32 (g->in_f64 0) or float64 (1); out: float32 (g->out_f64 0) or
// float64 (1; always for a float64 x), contiguous, one element a row; mask: bytes of 0 or 1, or
// null; partial: n_rows * n_chunks float64 where n_chunks > 1.
extern "C" int particle_sum(const Launch* g, const void* x, const void* mask, void* out,
                            void* partial, void* stream) {
  // the tensors belong to `g->device`, which need not be the calling
  // thread's current one: set it for the launch and give the old one back
  int prev = g->device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != g->device && (err = cudaSetDevice(g->device)) != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (g->in_f64) {
    launch_masked<double, double>(*g, x, mask, out, partial, s);
  } else if (g->out_f64) {
    launch_masked<float, double>(*g, x, mask, out, partial, s);
  } else {
    launch_masked<float, float>(*g, x, mask, out, partial, s);
  }
  err = cudaGetLastError();
  if (prev != g->device) cudaSetDevice(prev);
  return (int)err;
}

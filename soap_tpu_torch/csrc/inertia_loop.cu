// K2: the iterative ellipsoidal inertia loop, one thread-block cluster per
// halo.
//
// Replaces the Pallas TPU kernel `_inertia_kernel` of
// soap_tpu/ops/pallas_inertia.py (both its VMEM-resident form, `_call`,
// and its streaming form, `_call_stream_batched`), which the JAX package
// calls from soap_tpu/ops/inertia.py::inertia_tensor_multi.
//
// What bounds it on an H100: the per-iteration sweep.  Each iteration of
// each live config reads the config's rows -- positions (12 B/row),
// weights (4 B/row) and one mask word (4 B/row) -- and does ~25 f32 flops
// and 7 f64 adds per row; the rest is one scalar 3x3 eigensolve and
// update per (halo, config), ~10 us per iteration with the cluster
// barriers.  A halo's rows are re-read up to 20 times per config.  A
// batch of many halos (B = 256, K = 32768: 168 MB) streams them from
// device memory at ~2.6 TB/s, near the card's peak.  One giant halo
// (K = 2^20: 21 MB) sits in the 50 MB L2; its 16 SMs spend about half of
// each sweep on loads (~0.75 TB/s) and half on the row arithmetic.  One
// CTA per halo would leave a giant halo on one SM, ~18x slower than a
// cluster of 16 (PERF.md).
//
// Design:
//  - Grid = B x G CTAs in clusters of G (1..16) per halo; the wrapper
//    picks the largest G with B * G <= the SM count, one wave of one CTA
//    per SM (ops/inertia_loop.py::cluster_size).  Each config's rows
//    [0, n_eff) are cut into tiles of `tile` rows and the G CTAs take
//    contiguous runs of whole tiles.
//  - Each CTA (512 threads) streams its tiles of x, y, z, w and the
//    config's mask word through a 4-stage shared-memory ring: thread 0
//    starts one TMA 1D bulk copy per plane and tile (cp.async.bulk),
//    completing on the stage's mbarrier, with 3 tiles -- 60 KB (tile
//    1024) or 120 KB (tile 2048) -- in flight per CTA.  The same ring
//    filled by per-thread 16-byte cp.async copies was 5-35% slower.
//  - n_eff = min(the config's occupied prefix, the ellipsoid-extent
//    stop), the TPU kernel's `nblk_dyn` rule: on radius-sorted rows no
//    row beyond the ellipsoid's longest semi-axis amax can pass the
//    ellipsoid test, so the sweep ends after the last radius-table tile
//    whose first row lies within amax * (1 + margin).  The margin is
//    1e-3 + 1e-6 (amax/amin)^2: the f32 evaluation of rr has a rounding
//    error of ~1e-7 (amax/amin)^2, so without the margin a row just
//    beyond amax could still pass the f32 test rr <= 1, and the kernel
//    would differ from the plain version, which sweeps every row.  The
//    wrapper fills the table with -inf (no stop) unless the caller says
//    the rows are radius-sorted.
//  - Arithmetic: f32 products, f64 sums of the 7 moments, the build's
//    -fmad=false, cbrt as f64 pow and a float64 port of the closed-form
//    eigensolver (soap_tpu/ops/inertia.py::sym_eigh_3x3).  With f32 sums
//    in two different orders, a particle on the ellipsoid surface or a
//    config at the 1e-4 convergence threshold can fall either way; with
//    these rules every f32 quantity rounds as the plain PyTorch loop's
//    does, and the two agree bit for bit.
//  - Reduction: thread -> warp shuffle -> shared memory -> one f64 partial
//    per CTA and moment; rank 0 adds the G partials in rank order through
//    distributed shared memory.  No atomics: the result is deterministic.
//  - Rank 0, one thread per config, runs the eigensolve and the
//    convergence / update rules of the JAX while loop (TOL, q == 0,
//    per-config limit), forms the next ellipsoid and its extent, and
//    decides whether any config is live.  After a cluster barrier every
//    CTA copies that from rank 0, so all CTAs of a cluster take the same
//    branches and the same number of barriers (two per iteration).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;
constexpr int kPlanes = 5;  // x, y, z, w, mask word
constexpr int kPub = 8;     // per config: 6 form coefficients, extent, live
constexpr float kTol = 1.0e-4f;
// returned when no cluster of the requested size fits on the card
constexpr int kNoCluster = -1;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// one arrival that also expects `bytes` of bulk copies on the barrier
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

// TMA 1D bulk copy global -> this CTA's shared memory, completing on bar
__device__ __forceinline__ void bulk_copy(float* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ float cbrt_f(float x) {
  // the plain version's float64 pow, rounded to f32
  return (float)pow((double)x, 1.0 / 3.0);
}

__device__ void cross3(const double* a, const double* b, double* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// Eigenvector of symmetric A for eigenvalue lam: the largest of the
// three row cross products of (A - lam I), first one on ties.
__device__ void eigvec(const double A[3][3], double lam, double* v) {
  double M[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) M[i][j] = A[i][j] - (i == j ? lam : 0.0);
  double c[3][3];
  cross3(M[0], M[1], c[0]);
  cross3(M[0], M[2], c[1]);
  cross3(M[1], M[2], c[2]);
  double n[3];
  for (int k = 0; k < 3; ++k) n[k] = c[k][0] * c[k][0] + c[k][1] * c[k][1] + c[k][2] * c[k][2];
  int best = 0;
  if (n[1] > n[best]) best = 1;
  if (n[2] > n[best]) best = 2;
  double s = c[best][0] * c[best][0] + c[best][1] * c[best][1] + c[best][2] * c[best][2];
  double nrm = sqrt(s > 1e-37 ? s : 1e-37);
  for (int k = 0; k < 3; ++k) v[k] = c[best][k] / nrm;
}

// Closed-form eigendecomposition in float64; t = [xx, xy, xz, yy, yz, zz].
// w ascending; V[i][j] = component i of eigenvector j.
__device__ void sym_eigh_3x3(const float* t, float* w_out, float V_out[3][3]) {
  double A[3][3] = {{t[0], t[1], t[2]}, {t[1], t[3], t[4]}, {t[2], t[4], t[5]}};
  const double a00 = A[0][0], a11 = A[1][1], a22 = A[2][2];
  const double a01 = A[0][1], a02 = A[0][2], a12 = A[1][2];
  const double p1 = a01 * a01 + a02 * a02 + a12 * a12;
  const double q = (a00 + a11 + a22) / 3.0;
  const double p2 = (a00 - q) * (a00 - q) + (a11 - q) * (a11 - q) +
                    (a22 - q) * (a22 - q) + 2.0 * p1;
  const double p = sqrt((p2 > 0.0 ? p2 : 0.0) / 6.0);
  const double ps = p > 1e-30 ? p : 1e-30;
  double B[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) B[i][j] = (A[i][j] - (i == j ? q : 0.0)) / ps;
  const double detB = B[0][0] * (B[1][1] * B[2][2] - B[1][2] * B[2][1]) -
                      B[0][1] * (B[1][0] * B[2][2] - B[1][2] * B[2][0]) +
                      B[0][2] * (B[1][0] * B[2][1] - B[1][1] * B[2][0]);
  double r = detB / 2.0;
  r = r < -1.0 ? -1.0 : (r > 1.0 ? 1.0 : r);
  const double phi = acos(r) / 3.0;
  const double w2 = q + 2.0 * p * cos(phi);
  const double w0 = q + 2.0 * p * cos(phi + 2.0 * 3.14159265358979323846 / 3.0);
  const double w1 = 3.0 * q - w2 - w0;
  const double qq = q * q;
  const bool degenerate = p2 <= 1e-30 * (qq > 1e-30 ? qq : 1e-30);
  if (degenerate) {
    for (int i = 0; i < 3; ++i) {
      w_out[i] = (float)q;
      for (int j = 0; j < 3; ++j) V_out[i][j] = i == j ? 1.0f : 0.0f;
    }
    return;
  }
  double v0[3], v1[3], v2[3];
  eigvec(A, w0, v0);
  eigvec(A, w2, v2);
  const double d = v0[0] * v2[0] + v0[1] * v2[1] + v0[2] * v2[2];
  for (int k = 0; k < 3; ++k) v2[k] -= v0[k] * d;
  const double s2 = v2[0] * v2[0] + v2[1] * v2[1] + v2[2] * v2[2];
  const double n2 = sqrt(s2 > 1e-37 ? s2 : 1e-37);
  for (int k = 0; k < 3; ++k) v2[k] /= n2;
  cross3(v2, v0, v1);
  w_out[0] = (float)w0;
  w_out[1] = (float)w1;
  w_out[2] = (float)w2;
  for (int i = 0; i < 3; ++i) {
    V_out[i][0] = (float)v0[i];
    V_out[i][1] = (float)v1[i];
    V_out[i][2] = (float)v2[i];
  }
}

// The ellipsoid of eigenvalues val and eigenvectors vec (V[i][j] at
// 3i + j) at fixed volume 4/3 pi Rc^3, as the quadratic form
// rr = x.(Q x) = [q00, 2 q01, 2 q02, q11, 2 q12, q22] . monomials
// (pub[0..5]), and its extent: the largest first-row radius of a tile
// that can hold a row inside (pub[6], see the note at the top).
__device__ void ellipsoid(const float* val, const float* V, float Rc, float* pub) {
  const float v0 = val[0], v1 = val[1], v2 = val[2];
  const float q = sqrtf(v1 / v2);
  const float s = sqrtf(v0 / v2);
  const float p = sqrtf(v0 / v1);
  const float ax0 = Rc * cbrt_f(s * p);
  const float ax1 = Rc * cbrt_f(q / p);
  const float ax2 = Rc * (1.0f / cbrt_f(q * s));
  const float ia[3] = {1.0f / (ax0 * ax0), 1.0f / (ax1 * ax1), 1.0f / (ax2 * ax2)};
  float Q[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = i; j < 3; ++j)
      Q[i][j] = V[3 * i] * V[3 * j] * ia[0] + V[3 * i + 1] * V[3 * j + 1] * ia[1] +
                V[3 * i + 2] * V[3 * j + 2] * ia[2];
  pub[0] = Q[0][0];
  pub[1] = 2.0f * Q[0][1];
  pub[2] = 2.0f * Q[0][2];
  pub[3] = Q[1][1];
  pub[4] = 2.0f * Q[1][2];
  pub[5] = Q[2][2];
  // fmaxf and fminf skip a NaN axis; a NaN axis makes every Q entry NaN,
  // so no row passes, wherever the sweep stops
  const float amax = fmaxf(ax0, fmaxf(ax1, ax2));
  const float ratio = amax / fminf(ax0, fminf(ax1, ax2));
  const float extent = amax * (1.0f + 1.0e-3f + 1.0e-6f * ratio * ratio);
  pub[6] = extent >= 0.0f ? extent : __int_as_float(0x7f800000);  // NaN: no stop
}

__global__ void __launch_bounds__(kThreads, 2)
inertia_loop_kernel(const float* __restrict__ pos3, const float* __restrict__ w,
                    const int* __restrict__ mw, const float* __restrict__ R,
                    const int* __restrict__ reduced, const int* __restrict__ limit,
                    const int* __restrict__ occ, const int* __restrict__ done0,
                    const float* __restrict__ table, int K, int W, int C,
                    int max_iterations, int G, int tile, int table_rows, int n_table,
                    float* __restrict__ out) {
  cg::cluster_group cluster = cg::this_cluster();  // G CTAs
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / G;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);  // kStages x kPlanes x tile
  double* s_part = reinterpret_cast<double*>(ring + kStages * kPlanes * tile);  // C x 7
  float* s_tab = reinterpret_cast<float*>(s_part + 7 * C);  // n_table
  // rank 0's loop state (laid out in every CTA)
  float* s_val = s_tab + n_table;       // C x 3
  float* s_vec = s_val + 3 * C;         // C x 9, V[i][j] at 9c + 3i + j
  float* s_ten = s_vec + 9 * C;         // C x 6
  float* s_oldq = s_ten + 6 * C;        // C
  int* s_done = reinterpret_cast<int*>(s_oldq + C);  // C
  // what rank 0 publishes for the next iteration, and each CTA's copy
  float* s_pub = reinterpret_cast<float*>(s_done + C);  // C x kPub
  float* s_cur = s_pub + kPub * C;                      // C x kPub
  int* s_any = reinterpret_cast<int*>(s_cur + kPub * C);  // [published, copy]
  __shared__ double s_red[kWarps * 7];
  __shared__ unsigned long long s_bar[kStages];
  int ring_q = 0;  // tiles this CTA has streamed through the ring so far

  const long long bK = (long long)b * K;
  const float* px = pos3 + 3 * bK;
  const float* wb = w + bK;
  const unsigned* mwb = reinterpret_cast<const unsigned*>(mw) + (long long)b * W * K;
  const int bC = b * C;

  for (int j = tid; j < n_table; j += kThreads) s_tab[j] = table[(long long)b * n_table + j];
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(&s_bar[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (rank == 0) {
    for (int c = tid; c < C; c += kThreads) {
      for (int i = 0; i < 3; ++i) {
        s_val[3 * c + i] = 1.0f;
        for (int j = 0; j < 3; ++j) s_vec[9 * c + 3 * i + j] = i == j ? 1.0f : 0.0f;
      }
      for (int k = 0; k < 6; ++k) s_ten[6 * c + k] = 0.0f;
      s_oldq[c] = 1000.0f;
      s_done[c] = done0[bC + c] != 0;
      ellipsoid(s_val + 3 * c, s_vec + 9 * c, R[bC + c], s_pub + kPub * c);
      s_pub[kPub * c + 7] = s_done[c] ? 0.0f : 1.0f;
    }
    __syncthreads();
    if (tid == 0) {
      int any = 0;
      for (int c = 0; c < C; ++c) any |= !s_done[c];
      s_any[0] = any;
    }
  }
  cluster.sync();

  for (int it = 0; it < max_iterations; ++it) {
    {
      const float* pub = cluster.map_shared_rank(s_pub, 0);
      for (int e = tid; e < kPub * C; e += kThreads) s_cur[e] = pub[e];
      if (tid == 0) s_any[1] = *cluster.map_shared_rank(s_any, 0);
    }
    __syncthreads();
    if (!s_any[1]) break;  // the same decision in every CTA of the cluster

    for (int c = 0; c < C; ++c) {
      const float* cur = s_cur + kPub * c;
      if (cur[7] == 0.0f) continue;  // uniform: s_cur is not written in this loop
      const float q00 = cur[0], q01 = cur[1], q02 = cur[2];
      const float q11 = cur[3], q12 = cur[4], q22 = cur[5];
      const float extent = cur[6];
      // n_eff: occupied prefix, cut at the ellipsoid's extent
      int n_tiles_in = 0;
      for (int j0 = 0; j0 < n_table; j0 += kThreads) {
        const int j = j0 + tid;
        n_tiles_in += __syncthreads_count(j < n_table && s_tab[j] <= extent);
      }
      int n = occ[bC + c];
      n = n < K ? n : K;
      const long long n_ext = (long long)n_tiles_in * table_rows;
      if (n_ext < n) n = (int)n_ext;

      // this CTA's run of whole tiles
      const int nt_all = (n + tile - 1) / tile;
      const int t0 = (int)((long long)nt_all * rank / G);
      const int nt = (int)((long long)nt_all * (rank + 1) / G) - t0;
      const unsigned* word = mwb + (long long)(c >> 5) * K;
      const int bit = c & 31;
      const bool red = reduced[bC + c] != 0;

      // thread 0: bulk copies of the t-th tile of the run into its ring
      // stage; rows past n in its last 16 bytes are copied but never read
      auto fetch = [&](int t) {
        const int q = ring_q + t;
        const int st = q % kStages;
        const int r0 = (t0 + t) * tile;
        const int rows = n - r0 < tile ? n - r0 : tile;
        const unsigned bytes = (unsigned)((rows + 3) >> 2) * 16u;
        float* dst = ring + (long long)st * kPlanes * tile;
        // the CTA's earlier reads of this stage come before the copies' writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect_tx(&s_bar[st], kPlanes * bytes);
        bulk_copy(dst, px + r0, bytes, &s_bar[st]);
        bulk_copy(dst + tile, px + K + r0, bytes, &s_bar[st]);
        bulk_copy(dst + 2 * tile, px + 2LL * K + r0, bytes, &s_bar[st]);
        bulk_copy(dst + 3 * tile, wb + r0, bytes, &s_bar[st]);
        bulk_copy(dst + 4 * tile, word + r0, bytes, &s_bar[st]);
      };

      double acc[7] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
      if (tid == 0)
        for (int t = 0; t < kStages - 1 && t < nt; ++t) fetch(t);
      for (int t = 0; t < nt; ++t) {
        if (tid == 0 && t + kStages - 1 < nt) fetch(t + kStages - 1);
        const int q = ring_q + t;
        mbar_wait(&s_bar[q % kStages], (unsigned)(q / kStages) & 1u);
        const int r0 = (t0 + t) * tile;
        const int rows = n - r0 < tile ? n - r0 : tile;
        const float* sx = ring + (long long)(q % kStages) * kPlanes * tile;
        const float* sy = sx + tile;
        const float* sz = sy + tile;
        const float* sw = sz + tile;
        const unsigned* sm = reinterpret_cast<const unsigned*>(sw + tile);
        for (int k = tid; k < rows; k += kThreads) {
          if (!((sm[k] >> bit) & 1u)) continue;
          const float x = sx[k], y = sy[k], z = sz[k];
          const float rr = x * (q00 * x + q01 * y + q02 * z) + y * (q11 * y + q12 * z) + q22 * z * z;
          if (!(rr <= 1.0f)) continue;
          const float wv = sw[k];
          float wi = wv;
          if (red) {
            const float r2 = x * x + y * y + z * z;
            wi = wv * (1.0f / (fabsf(r2) <= 1e-8f ? 1.0f : r2));
          }
          // f32 products, f64 sums (see the note at the top)
          acc[0] += (double)(wi * x * x);
          acc[1] += (double)(wi * x * y);
          acc[2] += (double)(wi * x * z);
          acc[3] += (double)(wi * y * y);
          acc[4] += (double)(wi * y * z);
          acc[5] += (double)(wi * z * z);
          acc[6] += (double)wv;
        }
        __syncthreads();  // the stage is free for tile t + kStages
      }
      ring_q += nt;

      for (int m = 0; m < 7; ++m) {
        double v = acc[m];
        for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
        if ((tid & 31) == 0) s_red[(tid >> 5) * 7 + m] = v;
      }
      __syncthreads();
      if (tid < 7) {
        double v = s_red[tid];
        for (int wp = 1; wp < kWarps; ++wp) v += s_red[wp * 7 + tid];
        s_part[7 * c + tid] = v;
      }
      __syncthreads();
    }
    cluster.sync();  // every CTA's partials are in place

    if (rank == 0) {
      // per-config sum over ranks, eigensolve and update, one thread per config
      for (int c = tid; c < C; c += kThreads) {
        if (s_done[c]) continue;
        double tot[7];
        for (int r = 0; r < G; ++r) {
          const double* part = cluster.map_shared_rank(s_part, r) + 7 * c;
          for (int m = 0; m < 7; ++m) tot[m] = r == 0 ? part[m] : tot[m] + part[m];
        }
        const double inv = 1.0 / (tot[6] > 1e-37 ? tot[6] : 1e-37);
        float t_new[6];
        for (int m = 0; m < 6; ++m) t_new[m] = (float)(tot[m] * inv);
        const float q_now = sqrtf(s_val[3 * c + 1] / s_val[3 * c + 2]);
        const float qd = q_now > 1e-37f ? q_now : 1e-37f;
        const bool converged = fabsf((s_oldq[c] - q_now) / qd) < kTol;
        const bool degenerate = q_now == 0.0f;
        float wv[3], Vn[3][3];
        sym_eigh_3x3(t_new, wv, Vn);
        if (degenerate)
          for (int m = 0; m < 6; ++m) t_new[m] = 0.0f;
        const bool stop = converged || degenerate || (it + 1 >= limit[bC + c]);
        if (!converged)
          for (int m = 0; m < 6; ++m) s_ten[6 * c + m] = t_new[m];
        if (!(converged || degenerate)) {
          for (int i = 0; i < 3; ++i) {
            s_val[3 * c + i] = fabsf(wv[i]);
            for (int j = 0; j < 3; ++j) s_vec[9 * c + 3 * i + j] = Vn[i][j];
          }
          s_oldq[c] = q_now;
        }
        if (stop) s_done[c] = 1;
        ellipsoid(s_val + 3 * c, s_vec + 9 * c, R[bC + c], s_pub + kPub * c);
        s_pub[kPub * c + 7] = s_done[c] ? 0.0f : 1.0f;
      }
      __syncthreads();
      if (tid == 0) {
        int any = 0;
        for (int c = 0; c < C; ++c) any |= !s_done[c];
        s_any[0] = any;
      }
    }
    cluster.sync();  // the new state is published
  }

  if (rank == 0)
    for (int e = tid; e < 6 * C; e += kThreads) out[(long long)bC * 6 + e] = s_ten[e];
  cluster.sync();  // no CTA leaves while another may still read its shared memory
}

}  // namespace

extern "C" int inertia_loop_f32(int device, const float* pos3, const float* w, const int* mw,
                                const float* R, const int* reduced, const int* limit,
                                const int* occ, const int* done0, const float* table,
                                int B, int K, int W, int C, int max_iterations, int G,
                                int tile, int table_rows, int n_table, float* out,
                                void* stream) {
  const size_t smem = sizeof(float) * (size_t)kStages * kPlanes * tile +
                      sizeof(double) * 7 * (size_t)C +
                      sizeof(float) * ((size_t)n_table + (19 + 1 + 2 * kPub) * (size_t)C + 2);
  // the attributes, the occupancy query and the launch act on the
  // current device: make it the tensors' own
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      inertia_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(inertia_loop_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * (unsigned)G);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, inertia_loop_kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters == 0) return kNoCluster;
  err = cudaLaunchKernelEx(&cfg, inertia_loop_kernel, pos3, w, mw, R, reduced, limit, occ,
                           done0, table, K, W, C, max_iterations, G, tile, table_rows,
                           n_table, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

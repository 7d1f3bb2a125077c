// K2: the iterative ellipsoidal inertia loop, one CTA per halo.
//
// Replaces the Pallas TPU kernel `_inertia_kernel` of
// soap_tpu/ops/pallas_inertia.py (both its VMEM-resident form, `_call`,
// and its streaming form, `_call_stream_batched`), which the JAX package
// calls from soap_tpu/ops/inertia.py::inertia_tensor_multi.
//
// What bounds it on an H100: device-memory bytes of the per-iteration
// sweep.  Each iteration of each live config reads its occupied prefix of
// positions (12 B/row), weights (4 B/row) and one mask word (4 B/row) and
// does ~25 flops per row: far below the card's flop-per-byte balance.
// The rest -- a 3x3 eigensolve and the update per config -- is one
// scalar job per (halo, config) and iteration.
//
// Design: grid = B halos, 256 threads.  The configs of a halo are looped
// inside the CTA; their state (eigenvalues, eigenvectors, tensor, old q,
// done) lives in shared memory, so a halo never leaves its SM.  For each
// live config the threads stride over the config's occupied prefix of
// the radius-sorted rows (rows past it have no selected bit), test the
// ellipsoid, form each row's moments in f32, accumulate the 7 sums in f64
// and reduce them with warp shuffles plus shared memory.  The TPU kernel
// summed in f32; here the f64 sums, with the build's -fmad=false (no
// fused multiply-adds), make every f32 quantity -- the ellipsoid test,
// the normalised tensor -- round exactly as the plain PyTorch loop's
// does.  With f32 sums in two different orders, a particle on the
// ellipsoid surface or a config at the 1e-4 convergence threshold can
// fall either way, and at B = 256 halos of 32768 rows some do.  Then one
// thread per config runs a float64 port of the closed-form eigensolver
// (soap_tpu/ops/inertia.py::sym_eigh_3x3) and the convergence / update
// rules of the JAX while loop (TOL, q == 0, per-config limit), so the
// kernel follows the plain PyTorch loop step for step.  There is no cap
// on K: a giant halo is just a longer stride loop (the streaming mode of
// the TPU kernel has no counterpart).  Not done yet: splitting a giant
// halo's rows across CTAs, and the TPU kernel's early stop at the
// ellipsoid's extent.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kTol = 1.0e-4f;

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

__global__ void __launch_bounds__(kThreads)
inertia_loop_kernel(const float* __restrict__ pos3, const float* __restrict__ w,
                    const int* __restrict__ mw, const float* __restrict__ R,
                    const int* __restrict__ reduced, const int* __restrict__ limit,
                    const int* __restrict__ occ, const int* __restrict__ done0,
                    int K, int W, int C, int max_iterations, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_val = smem;            // C * 3
  float* s_vec = s_val + 3 * C;   // C * 9, V[i][j] at 9c + 3i + j
  float* s_ten = s_vec + 9 * C;   // C * 6
  float* s_tn = s_ten + 6 * C;    // C * 6: this iteration's tensor
  float* s_oldq = s_tn + 6 * C;   // C
  int* s_done = (int*)(s_oldq + C);  // C
  __shared__ double s_red[kWarps * 7];
  __shared__ int s_any;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const long long bK = (long long)b * K;
  const float* px = pos3 + 3 * bK;
  const float* py = px + K;
  const float* pz = py + K;
  const float* wb = w + bK;
  const unsigned* mwb = reinterpret_cast<const unsigned*>(mw) + (long long)b * W * K;
  const int bC = b * C;

  for (int c = tid; c < C; c += kThreads) {
    for (int i = 0; i < 3; ++i) {
      s_val[3 * c + i] = 1.0f;
      for (int j = 0; j < 3; ++j) s_vec[9 * c + 3 * i + j] = i == j ? 1.0f : 0.0f;
    }
    for (int k = 0; k < 6; ++k) s_ten[6 * c + k] = 0.0f;
    s_oldq[c] = 1000.0f;
    s_done[c] = done0[bC + c] != 0;
  }
  __syncthreads();

  for (int it = 0; it < max_iterations; ++it) {
    if (tid == 0) {
      int any = 0;
      for (int c = 0; c < C; ++c) any |= !s_done[c];
      s_any = any;
    }
    __syncthreads();
    if (!s_any) break;

    for (int c = 0; c < C; ++c) {
      if (s_done[c]) continue;  // uniform: s_done is not written in this loop
      // ellipsoid quadratic form Q = V diag(1/axis^2) V^T, every thread
      const float v0 = s_val[3 * c], v1 = s_val[3 * c + 1], v2 = s_val[3 * c + 2];
      const float q = sqrtf(v1 / v2);
      const float s = sqrtf(v0 / v2);
      const float p = sqrtf(v0 / v1);
      const float Rc = R[bC + c];
      const float ax0 = Rc * cbrt_f(s * p);
      const float ax1 = Rc * cbrt_f(q / p);
      const float ax2 = Rc * (1.0f / cbrt_f(q * s));
      const float ia[3] = {1.0f / (ax0 * ax0), 1.0f / (ax1 * ax1), 1.0f / (ax2 * ax2)};
      const float* V = s_vec + 9 * c;
      float Q[3][3];
      for (int i = 0; i < 3; ++i)
        for (int j = i; j < 3; ++j)
          Q[i][j] = V[3 * i] * V[3 * j] * ia[0] + V[3 * i + 1] * V[3 * j + 1] * ia[1] +
                    V[3 * i + 2] * V[3 * j + 2] * ia[2];
      const float q00 = Q[0][0], q11 = Q[1][1], q22 = Q[2][2];
      const float q01 = 2.0f * Q[0][1], q02 = 2.0f * Q[0][2], q12 = 2.0f * Q[1][2];
      const bool red = reduced[bC + c] != 0;
      const unsigned* word = mwb + (long long)(c >> 5) * K;
      const int bit = c & 31;
      int n = occ[bC + c];
      n = n < K ? n : K;

      double acc[7] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
      for (int k = tid; k < n; k += kThreads) {
        if (!((__ldg(word + k) >> bit) & 1u)) continue;
        const float x = __ldg(px + k), y = __ldg(py + k), z = __ldg(pz + k);
        const float rr = x * (q00 * x + q01 * y + q02 * z) + y * (q11 * y + q12 * z) + q22 * z * z;
        if (!(rr <= 1.0f)) continue;
        const float wv = __ldg(wb + k);
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
      for (int m = 0; m < 7; ++m) {
        double v = acc[m];
        for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
        if ((tid & 31) == 0) s_red[(tid >> 5) * 7 + m] = v;
      }
      __syncthreads();
      if (tid == 0) {
        double tot[7];
        for (int m = 0; m < 7; ++m) {
          double v = 0.0;
          for (int wp = 0; wp < kWarps; ++wp) v += s_red[wp * 7 + m];
          tot[m] = v;
        }
        const double inv = 1.0 / (tot[6] > 1e-37 ? tot[6] : 1e-37);
        for (int m = 0; m < 6; ++m) s_tn[6 * c + m] = (float)(tot[m] * inv);
      }
      __syncthreads();
    }

    // per-config eigensolve and update, one thread per config
    for (int c = tid; c < C; c += kThreads) {
      if (s_done[c]) continue;
      const float q_now = sqrtf(s_val[3 * c + 1] / s_val[3 * c + 2]);
      const float qd = q_now > 1e-37f ? q_now : 1e-37f;
      const bool converged = fabsf((s_oldq[c] - q_now) / qd) < kTol;
      const bool degenerate = q_now == 0.0f;
      float t_new[6];
      for (int m = 0; m < 6; ++m) t_new[m] = s_tn[6 * c + m];
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
    }
    __syncthreads();
  }

  for (int e = tid; e < 6 * C; e += kThreads) out[(long long)bC * 6 + e] = s_ten[e];
}

}  // namespace

extern "C" int inertia_loop_f32(const float* pos3, const float* w, const int* mw,
                                const float* R, const int* reduced, const int* limit,
                                const int* occ, const int* done0, int B, int K, int W,
                                int C, int max_iterations, float* out, void* stream) {
  const size_t smem = sizeof(float) * (size_t)(25 * C) + sizeof(int) * (size_t)C;
  inertia_loop_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      pos3, w, mw, R, reduced, limit, occ, done0, K, W, C, max_iterations, out);
  return (int)cudaGetLastError();
}

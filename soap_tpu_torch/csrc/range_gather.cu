// K1: run-length range gather of the cell-sorted particle store.
//
// Replaces the Pallas TPU kernel `_make_kernel` / `range_gather_lines` of
// soap_tpu/ops/dma_gather.py, which walks each halo's block table and
// keeps 8 HBM->HBM DMAs in flight.
//
// What bounds it on an H100: device-memory bytes.  The kernel does no
// arithmetic; it reads and writes every gathered row once, so one call
// moves 2 * B * capacity * F * 4 bytes.
//
// Design: one CTA copies BLOCKS_PER_CTA whole S-row blocks of one halo
// (grid = (B, ceil(R / BLOCKS_PER_CTA))).  Each block's source row comes
// from the CTA's own load of table[b, j] -- there is no scalar prefetch
// on this card.  A block of S rows x F f32 columns is copied as float4s,
// neighbouring threads on neighbouring 16-byte words (for the DMO store,
// S = 64 and F = 16: 4 KB, one float4 for each of 256 threads), so both
// the loads and the stores coalesce.  Source rows are clipped to the
// store, which makes the result bit-identical to the plain index gather
// `packed[clip(table[:, :, None] + arange(S), 0, N - 1)]`.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerCta = 4;

__global__ void __launch_bounds__(kThreads)
range_gather_kernel(const float4* __restrict__ packed, long long n_rows,
                    int f4,  // float4s per row (F / 4)
                    const int* __restrict__ table, int R, int S,
                    float4* __restrict__ out) {
  const int b = blockIdx.x;
  const int j0 = blockIdx.y * kBlocksPerCta;
  const int per_block = S * f4;
  for (int jj = 0; jj < kBlocksPerCta; ++jj) {
    const int j = j0 + jj;
    if (j >= R) return;
    const long long src_row = table[(long long)b * R + j];
    float4* dst = out + ((long long)b * R + j) * per_block;
    for (int e = threadIdx.x; e < per_block; e += kThreads) {
      const int r = e / f4;
      const int c = e - r * f4;
      long long row = src_row + r;
      row = row < 0 ? 0 : (row >= n_rows ? n_rows - 1 : row);
      dst[e] = __ldg(packed + row * f4 + c);
    }
  }
}

}  // namespace

extern "C" int range_gather_f32(int device, const float* packed, long long n_rows, int F,
                                const int* table, int B, int R, int S,
                                float* out, void* stream) {
  // the stream and the tensors belong to `device`, which need not be
  // the calling thread's current one
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, (R + kBlocksPerCta - 1) / kBlocksPerCta);
  range_gather_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(packed), n_rows, F / 4, table, R, S,
      reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}

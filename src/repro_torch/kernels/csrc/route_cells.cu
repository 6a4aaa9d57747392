// route_cells and fold_cells: the first two stages of the staged map.
//
// route_cells replaces the Pallas `_route_cells_kernel`
// (src/repro/kernels/route_cells.py:37, launched by `route_cells` at
// :96/:114): the hypercube base cell of every row,
// sum_i (top bits_i of row[col_i] * seed_i * MULT) * stride_i over uint32.
// The host drops share-1 axes and passes the rest as an int64 descriptor of
// (col, seed, bits, stride) records (common.cuh's hashed_cell walks it).
// One thread per row; bound: reading the hashed columns, writing the cells.
//
// fold_cells replaces `_fold_cells_kernel` (route_cells.py:51, launched by
// `fold_cells` at :66/:82): out = table[dest] for dest in [0, k), -1 for
// dest < 0, and 0 for dest >= k, as the TPU kernel's one-hot sum gives (it
// finds no match); the kernel never reads past the table.  The TPU kernel's
// one-hot contraction exists to avoid a gather there; here the (k,) table
// sits in shared memory when it fits (FOLD_SMEM_WORDS) and each thread
// gathers from it.  Grid-stride, so a block loads the table once for many
// elements.  Bound: reading dest and writing out.
#include "common.cuh"

#define FOLD_THREADS 256
#define FOLD_MAX_BLOCKS (132 * 16)
#define FOLD_SMEM_WORDS 8192

static __global__ void route_cells_kernel(const int* rows, long long n, int w,
                                          const long long* desc, int n_hashed,
                                          int* out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = (int)hashed_cell(rows + i * w, desc, n_hashed);
}

extern "C" int route_cells_launch(const int* rows, long long n, int w,
                                  const long long* desc, int n_hashed,
                                  int* out, void* stream) {
  route_cells_kernel<<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
      rows, n, w, desc, n_hashed, out);
  return (int)cudaGetLastError();
}

static __global__ void fold_cells_kernel(const int* dest, long long m,
                                         const int* table, int k, int* out) {
  __shared__ int smem[FOLD_SMEM_WORDS];
  const bool in_smem = k <= FOLD_SMEM_WORDS;
  if (in_smem)
    for (int j = threadIdx.x; j < k; j += blockDim.x) smem[j] = table[j];
  __syncthreads();
  const int* tab = in_smem ? smem : table;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    const int d = dest[i];
    out[i] = d < 0 ? -1 : (d < k ? tab[d] : 0);
  }
}

extern "C" int fold_cells_launch(const int* dest, long long m,
                                 const int* table, int k, int* out,
                                 void* stream) {
  unsigned blocks = blocks_for(m, FOLD_THREADS);
  if (blocks > FOLD_MAX_BLOCKS) blocks = FOLD_MAX_BLOCKS;
  fold_cells_kernel<<<blocks, FOLD_THREADS, 0, (cudaStream_t)stream>>>(
      dest, m, table, k, out);
  return (int)cudaGetLastError();
}

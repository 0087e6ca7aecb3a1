// The fused iteration of preconditioned CG for Hopper (sm_90a): four
// kernels that run one CG iteration after the product a = A p (K1 or K2),
// in place on workspaces the solve allocates once, with every scalar on
// the device.
//
// Replaces no Pallas TPU kernel: the JAX package leaves the iteration of
// jax.scipy.sparse.linalg.cg to XLA, which fuses its elementwise updates
// and dots itself.  In PyTorch the same loop ran as about 22 launches and
// 36 passes over the (q, N) state a CG iteration, each dot a cuBLAS call
// and each scalar its own kernel.  These kernels do the same arithmetic in
// four launches and 14 passes:
//
//   cg_pap:       part_pap[b] = sum over block b's elements of p * a
//   cg_update:    gamma = sum(part_rz), alpha = gamma / (s * sum(part_pap)),
//                 x += alpha p,  r -= alpha s a,  part_rr[b] = <r, r> of b,
//                 sc[0] = gamma
//   cg_precond:   z = s M^-1 r (block-Jacobi inverses or the Jacobi
//                 diagonal), part_rz[b] = <r, z> of b
//   cg_direction: beta = sum(part_rz) / sc[0],  p = z + beta p,
//                 flag = sum(part_rr) > sc[1]  (sc[1] = atol^2)
//
// s = +-1 carries Krylov.negate: CG runs on (sA) x = s b without a
// negation pass.  Every reduction ends in a fixed order: each block writes
// one partial sum (a shuffle tree, then the warps' sums in order), and
// each consumer sums all partials itself, every block the same way, so a
// run repeats bit for bit and every block reads the same scalar.
//
// What bounds them on the card: bytes.  At the main path's shapes (Rail
// n = 79841, q = 48 columns, f64: 30.7 MB a vector) the four kernels move
// 11 vectors (pap 2, update 6, direction 3) plus the block-Jacobi pass
// (r read, z written, 81.8 MB of inverses): 480 MB, 143 us at 3.35 TB/s;
// cg_precond reads r a second time, for <r, z>.
// The block product does 2 q bs^2 operations per block (0.98 GFLOP at
// q = 48), 15 us at the f64 tensor-core peak.
//
// Design: the elementwise kernels take a grid of at most CG_MAX_PARTS
// blocks that depends on the element count alone, each block striding over
// the flat, contiguous state in pairs of elements (layout does not matter
// to them).  The block-Jacobi kernel takes one CTA per (bs-row block,
// chunk of up to 16 M columns), with element strides for both axes, so it
// reads the lane-major (q, N) Krylov state of DIA and the column-major
// (n, q) state of block-ELL in place: no pad, no permute copy.  It stages
// the block's inverse and the operand's slice in chunks of CG_KB block
// columns by cp.async, the next chunk in flight while the tensor cores
// (DMMA m16n8k4, f64) work on this one, then writes z through shared
// memory along the operand's unit-stride axis, with all of a thread's
// loads of r for <r, z> in flight at once.  Rows past the operand's end
// are read as zero and not written, as the plain version's pad and crop do.

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#define CG_THREADS 256
#define CG_WARPS (CG_THREADS / 32)
#define CG_MAX_PARTS 1024  // blocks of the elementwise kernels (cg_fused.MAX_PARTS)
#define CG_BS_MAX 128      // widest block-Jacobi block (cg_fused.MAX_BS)
#define CG_KB 32           // block columns staged per pass
#define CG_TILE 16         // rows of an mma tile; a block CTA takes 16 M columns

// Sum over the block; every thread returns the same value, summed in a
// fixed order.  `sh` holds CG_WARPS values.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* sh) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    __syncthreads();  // an earlier sum has been read from sh
    if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
    __syncthreads();
    T s = sh[0];
#pragma unroll
    for (int w = 1; w < CG_WARPS; ++w) s += sh[w];
    return s;
}

// Sum of `n` partials, the same in every block.
template <typename T>
__device__ __forceinline__ T sum_parts(const T* __restrict__ parts, int n, T* sh) {
    T acc = T(0);
    for (int k = threadIdx.x; k < n; k += CG_THREADS) acc += parts[k];
    return block_sum(acc, sh);
}

// The elementwise kernels walk the state in pairs of elements (16 or 8
// bytes a load) when every array is aligned to two elements (VEC), the odd last
// element in block 0; element i of pair k is element 2 k + i.
template <typename T>
struct Pair;
template <>
struct Pair<double> {
    using type = double2;
};
template <>
struct Pair<float> {
    using type = float2;
};

#define CG_FOR(k, n) \
    for (long long k = (long long)blockIdx.x * CG_THREADS + threadIdx.x; k < (n); \
         k += (long long)gridDim.x * CG_THREADS)
#define CG_TAIL(VEC, L) ((VEC) && ((L) & 1) && blockIdx.x == 0 && threadIdx.x == 0)

template <typename T, bool VEC>
__global__ void __launch_bounds__(CG_THREADS)
cg_pap_kernel(const T* __restrict__ p, const T* __restrict__ a, long long L,
              T* __restrict__ part_pap) {
    using P2 = typename Pair<T>::type;
    __shared__ T sh[CG_WARPS];
    T acc = T(0);
    if (VEC) {
        CG_FOR(k, L / 2) {
            const P2 pv = reinterpret_cast<const P2*>(p)[k];
            const P2 av = reinterpret_cast<const P2*>(a)[k];
            acc += pv.x * av.x;
            acc += pv.y * av.y;
        }
        if (CG_TAIL(VEC, L)) acc += p[L - 1] * a[L - 1];
    } else {
        CG_FOR(i, L) acc += p[i] * a[i];
    }
    acc = block_sum(acc, sh);
    if (threadIdx.x == 0) part_pap[blockIdx.x] = acc;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(CG_THREADS)
cg_update_kernel(T* __restrict__ x, T* __restrict__ r, const T* __restrict__ p,
                 const T* __restrict__ a, long long L,
                 const T* __restrict__ part_pap, int n_pap,
                 const T* __restrict__ part_rz, int n_rz, T s,
                 T* __restrict__ sc, T* __restrict__ part_rr) {
    using P2 = typename Pair<T>::type;
    __shared__ T sh[CG_WARPS];
    const T gamma = sum_parts(part_rz, n_rz, sh);
    const T alpha = gamma / (s * sum_parts(part_pap, n_pap, sh));
    const T alpha_s = alpha * s;
    if (blockIdx.x == 0 && threadIdx.x == 0) sc[0] = gamma;  // read by cg_direction
    auto one = [&](long long e) {
        x[e] += alpha * p[e];
        const T re = r[e] - alpha_s * a[e];
        r[e] = re;
        return re * re;
    };
    T acc = T(0);
    if (VEC) {
        CG_FOR(k, L / 2) {
            P2 xv = reinterpret_cast<P2*>(x)[k], rv = reinterpret_cast<P2*>(r)[k];
            const P2 pv = reinterpret_cast<const P2*>(p)[k];
            const P2 av = reinterpret_cast<const P2*>(a)[k];
            xv.x += alpha * pv.x;
            xv.y += alpha * pv.y;
            rv.x -= alpha_s * av.x;
            rv.y -= alpha_s * av.y;
            reinterpret_cast<P2*>(x)[k] = xv;
            reinterpret_cast<P2*>(r)[k] = rv;
            acc += rv.x * rv.x;
            acc += rv.y * rv.y;
        }
        if (CG_TAIL(VEC, L)) acc += one(L - 1);
    } else {
        CG_FOR(i, L) acc += one(i);
    }
    acc = block_sum(acc, sh);
    if (threadIdx.x == 0) part_rr[blockIdx.x] = acc;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(CG_THREADS)
cg_direction_kernel(const T* __restrict__ z, T* __restrict__ p, long long L,
                    const T* __restrict__ part_rz, int n_rz, const T* __restrict__ sc,
                    const T* __restrict__ part_rr, int n_rr, int* __restrict__ flag) {
    using P2 = typename Pair<T>::type;
    __shared__ T sh[CG_WARPS];
    const T beta = sum_parts(part_rz, n_rz, sh) / sc[0];
    if (VEC) {
        CG_FOR(k, L / 2) {
            const P2 zv = reinterpret_cast<const P2*>(z)[k];
            P2 pv = reinterpret_cast<P2*>(p)[k];
            pv.x = zv.x + beta * pv.x;
            pv.y = zv.y + beta * pv.y;
            reinterpret_cast<P2*>(p)[k] = pv;
        }
        if (CG_TAIL(VEC, L)) p[L - 1] = z[L - 1] + beta * p[L - 1];
    } else {
        CG_FOR(i, L) p[i] = z[i] + beta * p[i];
    }
    if (blockIdx.x == 0) {  // uniform in the block
        const T rr = sum_parts(part_rr, n_rr, sh);
        if (threadIdx.x == 0) flag[0] = rr > sc[1] ? 1 : 0;
    }
}

// Jacobi: z = s d[i] r, on a contiguous state (lane-major when si == 1).
template <typename T>
__global__ void __launch_bounds__(CG_THREADS)
cg_jacobi_kernel(const T* __restrict__ r, T* __restrict__ z, const T* __restrict__ d,
                 int rows, int q, long long si, T s, T* __restrict__ part_rz) {
    __shared__ T sh[CG_WARPS];
    const long long L = (long long)rows * q;
    const long long stride = (long long)gridDim.x * CG_THREADS;
    T acc = T(0);
    for (long long e = (long long)blockIdx.x * CG_THREADS + threadIdx.x; e < L; e += stride) {
        const long long i = si == 1 ? e % rows : e / q;
        const T ri = r[e];
        const T zi = s * (d[i] * ri);
        z[e] = zi;
        acc += ri * zi;
    }
    acc = block_sum(acc, sh);
    if (threadIdx.x == 0) part_rz[blockIdx.x] = acc;
}

// Copy one element global -> shared, asynchronously (cp.async); an invalid
// one writes zero and reads nothing.
template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem, bool valid) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(gmem),
                 "n"((int)sizeof(T)), "r"(valid ? (int)sizeof(T) : 0));
}

// Copy 16 bytes global -> shared, asynchronously and around L1; an invalid
// copy writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D = A B + D for one 16x8 tile, K = 4, in f64 on the tensor cores (the
// Hopper shape): with g = l / 4 and t = l % 4, lane l holds A[g][t],
// A[g + 8][t], B[t][g], and D[g][2t + {0, 1}], D[g + 8][2t + {0, 1}].
__device__ __forceinline__ void dmma(double (&d)[4], double a0, double a1, double b) {
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
        "{%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a0), "d"(a1), "d"(b));
}

#define CG_LDK (CG_KB + 4)      // shared row of CG_KB block columns, padded
#define CG_LDA (CG_BS_MAX + 4)  // shared row of CG_BS_MAX block rows, padded

// Shared memory of one stage of the block kernel, in elements: a chunk of
// CG_KB columns of the inverse and of the operand, each laid out along its
// unit-stride axis in global memory (so the copies coalesce), padded so the
// fragment reads below hit distinct banks.
template <int CQ>
struct BlockStage {
    static constexpr int INV = CG_BS_MAX * CG_LDK > CG_KB * CG_LDA ? CG_BS_MAX * CG_LDK
                                                                   : CG_KB * CG_LDA;
    static constexpr int R = CQ * CG_LDK > CG_KB * (CQ + 4) ? CQ * CG_LDK : CG_KB * (CQ + 4);
    static constexpr int SIZE = INV + R;
};

// Block-Jacobi: CTA (j, y) computes z[i, c] = s sum_b inv[j][a][b] r[j bs + b, c]
// for i = j bs + a and the columns c of chunk y, 16 M of them: the product
// Z = R inv_j^T of a (16 M x bs) slice of the operand and the block's
// inverse.  r and z are addressed as base[i * si + c * sc], inv[j][a][b] as
// inv[j * sj + a * sa + b * sb] (PyTorch's batched inverse comes
// column-major, a copy into new storage row-major).  Chunks of CG_KB
// columns of both are staged by cp.async, two stages in flight.  Warp w
// takes rows a in [16 w, 16 w + 16) of Z's 16x8 tiles, all 16 M columns c;
// in f64 each tile is a run of DMMAs, in f32 each lane computes the same
// entries of it with scalar FMAs.
template <typename T, int M>
__global__ void __launch_bounds__(CG_THREADS, 2)
cg_block_kernel(const T* __restrict__ r, T* __restrict__ z, const T* __restrict__ inv,
                long long sj, long long sa, long long sb, int bs, int rows, int q,
                long long si, long long sc, T s, T* __restrict__ part_rz) {
    constexpr int CQ = CG_TILE * M;
    constexpr int TA = CG_BS_MAX / 8 / CG_WARPS;  // 8-wide tiles of a per warp
    using Stage = BlockStage<CQ>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* smem = reinterpret_cast<T*>(smem_raw);
    __shared__ T sh[CG_WARPS];
    const int j = blockIdx.x;
    const int c0 = blockIdx.y * CQ;
    const long long i0 = (long long)j * bs;
    const T* inv_j = inv + (long long)j * sj;
    // Shared strides: inv_s[a * ia + bb * ib], r_s[cc * rc + bb * rb].
    const bool inv_rows = sb == 1;
    const bool lane_major = si == 1;
    const int ia = inv_rows ? CG_LDK : 1, ib = inv_rows ? 1 : CG_LDA;
    const int rc = lane_major ? CG_LDK : 1, rb = lane_major ? 1 : CQ + 4;
    const int n_chunks = (bs + CG_KB - 1) / CG_KB;

    // The inverse moves in 16-byte pieces (PE elements along its unit-stride
    // axis) where its layout allows; bs even keeps a piece inside the block.
    constexpr int PE = 16 / sizeof(T);
    const long long unit = inv_rows ? sa : sb;
    const bool pieces = reinterpret_cast<uintptr_t>(inv) % 16 == 0 && sj % PE == 0 &&
                        unit % PE == 0 && bs % PE == 0;

    auto stage = [&](int chunk, int buf) {
        T* inv_s = smem + buf * Stage::SIZE;
        T* r_s = inv_s + Stage::INV;
        const int b0 = chunk * CG_KB;
        const int pe = pieces ? PE : 1;
        for (int e = threadIdx.x; e < CG_KB * CG_BS_MAX / pe; e += CG_THREADS) {
            int bb, a;
            if (inv_rows) {
                bb = e % (CG_KB / pe) * pe;
                a = e / (CG_KB / pe);
            } else {
                a = e % (CG_BS_MAX / pe) * pe;
                bb = e / (CG_BS_MAX / pe);
            }
            const bool ok = a < bs && b0 + bb < bs;
            const T* src = ok ? inv_j + a * sa + (b0 + bb) * sb : inv;
            if (pieces)
                cp_async16(inv_s + a * ia + bb * ib, src, ok);
            else
                cp_async(inv_s + a * ia + bb * ib, src, ok);
        }
        for (int e = threadIdx.x; e < CQ * CG_KB; e += CG_THREADS) {
            int bb, cc;
            if (lane_major) {
                bb = e % CG_KB;
                cc = e / CG_KB;
            } else {
                cc = e % CQ;
                bb = e / CQ;
            }
            const long long i = i0 + b0 + bb;
            const int c = c0 + cc;
            const bool ok = b0 + bb < bs && i < rows && c < q;
            cp_async(r_s + cc * rc + bb * rb, ok ? r + i * si + (long long)c * sc : r, ok);
        }
        cp_async_commit();
    };

    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int col0 = (threadIdx.x >> 5) * TA * 8;  // the warp's first row of the block (a)
    // acc[t][u][2 h + v] is Z[16 t + g + 8 h][col0 + 8 u + 2 tq + v].
    T acc[M][TA][4];
#pragma unroll
    for (int t = 0; t < M; ++t)
#pragma unroll
        for (int u = 0; u < TA; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[t][u][e] = T(0);

    stage(0, 0);
    for (int chunk = 0; chunk < n_chunks; ++chunk) {
        if (chunk + 1 < n_chunks) {
            stage(chunk + 1, (chunk + 1) & 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const T* inv_s = smem + (chunk & 1) * Stage::SIZE;
        const T* r_s = inv_s + Stage::INV;
        if constexpr (std::is_same<T, double>::value) {
#pragma unroll
            for (int k0 = 0; k0 < CG_KB; k0 += 4) {
                double af[M][2], bf[TA];
#pragma unroll
                for (int t = 0; t < M; ++t)
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                        af[t][h] = r_s[(16 * t + 8 * h + g) * rc + (k0 + tq) * rb];
#pragma unroll
                for (int u = 0; u < TA; ++u) bf[u] = inv_s[(col0 + 8 * u + g) * ia + (k0 + tq) * ib];
#pragma unroll
                for (int t = 0; t < M; ++t)
#pragma unroll
                    for (int u = 0; u < TA; ++u) dmma(acc[t][u], af[t][0], af[t][1], bf[u]);
            }
        } else {
#pragma unroll 4
            for (int k = 0; k < CG_KB; ++k) {
                T av[M][2], bv[TA][2];
#pragma unroll
                for (int t = 0; t < M; ++t)
#pragma unroll
                    for (int h = 0; h < 2; ++h) av[t][h] = r_s[(16 * t + 8 * h + g) * rc + k * rb];
#pragma unroll
                for (int u = 0; u < TA; ++u)
#pragma unroll
                    for (int v = 0; v < 2; ++v)
                        bv[u][v] = inv_s[(col0 + 8 * u + 2 * tq + v) * ia + k * ib];
#pragma unroll
                for (int t = 0; t < M; ++t)
#pragma unroll
                    for (int u = 0; u < TA; ++u)
#pragma unroll
                        for (int e = 0; e < 4; ++e) acc[t][u][e] += av[t][e >> 1] * bv[u][e & 1];
            }
        }
        __syncthreads();
    }
    // The tile goes out through shared memory (the stages are free now),
    // laid out along the operand's unit-stride axis, so that the stores of z
    // and the loads of r for <r, z> coalesce.
    T* z_s = smem;
    const int za = lane_major ? 1 : CQ + 2, zc = lane_major ? CG_BS_MAX + 8 : 1;
#pragma unroll
    for (int t = 0; t < M; ++t)
#pragma unroll
        for (int u = 0; u < TA; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                z_s[(16 * t + 8 * (e >> 1) + g) * zc + (col0 + 8 * u + 2 * tq + (e & 1)) * za] =
                    acc[t][u][e];
    __syncthreads();
    // Each thread's PER entries: all of its loads of r go out before the
    // first is used, so they are in flight together.
    constexpr int PER = CQ * CG_BS_MAX / CG_THREADS;
    auto entry = [&](int k, int& a, int& cc) {
        const int e = threadIdx.x + k * CG_THREADS;
        if (lane_major) {
            a = e % CG_BS_MAX;
            cc = e / CG_BS_MAX;
        } else {
            cc = e % CQ;
            a = e / CQ;
        }
        return a < bs && i0 + a < rows && c0 + cc < q;
    };
    T rv[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        int a, cc;
        rv[k] = entry(k, a, cc) ? r[(i0 + a) * si + (long long)(c0 + cc) * sc] : T(0);
    }
    T dot = T(0);
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        int a, cc;
        if (entry(k, a, cc)) {
            const T zv = s * z_s[cc * zc + a * za];
            z[(i0 + a) * si + (long long)(c0 + cc) * sc] = zv;
            dot += rv[k] * zv;
        }
    }
    dot = block_sum(dot, sh);
    if (threadIdx.x == 0) part_rz[blockIdx.y * gridDim.x + blockIdx.x] = dot;
}

static int elementwise_grid(long long L, int nparts) {
    if (L < 1 || nparts < 1 || nparts > CG_MAX_PARTS) return -1;
    return nparts;
}

template <typename T, int M>
static int launch_block(const T* r, T* z, const T* inv, long long sj, long long sa,
                        long long sb, int nb, int bs, int rows, int q, long long si,
                        long long sc, T s, T* part, int nparts, cudaStream_t st) {
    constexpr int CQ = CG_TILE * M;
    const int ny = (q + CQ - 1) / CQ;
    if (nparts != nb * ny || ny > 65535) return (int)cudaErrorInvalidValue;
    const size_t smem = 2 * sizeof(T) * BlockStage<CQ>::SIZE;  // two stages
    static bool attr_set = false;  // once per variant (and process)
    if (!attr_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            cg_block_kernel<T, M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        attr_set = true;
    }
    cg_block_kernel<T, M><<<dim3((unsigned)nb, (unsigned)ny), CG_THREADS, smem, st>>>(
        r, z, inv, sj, sa, sb, bs, rows, q, si, sc, s, part);
    return (int)cudaGetLastError();
}

// Columns of one CTA: the smallest of 16, 32, 48 and 64 that holds q
// (64 and chunks of 64 beyond).
template <typename T>
static int launch_precond(const T* r, T* z, const T* prec, long long sj, long long sa,
                          long long sb, int nb, int bs, int rows, int q, long long si,
                          long long sc, double s, T* part, int nparts, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (rows < 1 || q < 1) return (int)cudaErrorInvalidValue;
    if (bs == 0) {  // Jacobi: prec is the diagonal's reciprocal
        if (elementwise_grid((long long)rows * q, nparts) < 0) return (int)cudaErrorInvalidValue;
        cg_jacobi_kernel<T><<<nparts, CG_THREADS, 0, st>>>(r, z, prec, rows, q, si, (T)s, part);
        return (int)cudaGetLastError();
    }
    if (bs < 1 || bs > CG_BS_MAX || nb < 1 || (long long)nb * bs < rows)
        return (int)cudaErrorInvalidValue;
#define CG_BLOCK(M) \
    launch_block<T, M>(r, z, prec, sj, sa, sb, nb, bs, rows, q, si, sc, (T)s, part, nparts, st)
    if (q <= 16) return CG_BLOCK(1);
    if (q <= 32) return CG_BLOCK(2);
    if (q <= 48) return CG_BLOCK(3);
    return CG_BLOCK(4);
#undef CG_BLOCK
}

// Whether the elementwise kernels may load pairs: every array aligned to
// two elements.
template <typename T>
static bool pairs_aligned(std::initializer_list<const void*> ptrs) {
    for (const void* ptr : ptrs)
        if (reinterpret_cast<uintptr_t>(ptr) % (2 * sizeof(T)) != 0) return false;
    return true;
}

// Plain C interface (loaded with ctypes).  Every vector is a contiguous
// array of L elements in one layout; `part_*` arrays hold one partial sum
// per block of the kernel that writes them (`n_*` of them); `sc` holds
// {gamma, atol^2}; `flag` one int.  cg_precond's r and z are addressed as
// base[i * si + c * sc] for row i < rows and column c < q; `prec` is the
// (nb, bs, bs) inverses with strides (sj, sa, sb), or the diagonal's
// reciprocal (unit stride) with bs = 0.  Each returns the CUDA error code
// of its launch.
#define CG_DEFINE(SUFFIX, T)                                                                    \
    extern "C" int cg_pap_##SUFFIX(const void* p, const void* a, long long L, void* part_pap,    \
                                   int nparts, void* stream) {                                  \
        if (elementwise_grid(L, nparts) < 0) return (int)cudaErrorInvalidValue;                 \
        auto k = pairs_aligned<T>({p, a}) ? cg_pap_kernel<T, true> : cg_pap_kernel<T, false>;  \
        k<<<nparts, CG_THREADS, 0, (cudaStream_t)stream>>>((const T*)p, (const T*)a, L,         \
                                                            (T*)part_pap);                      \
        return (int)cudaGetLastError();                                                         \
    }                                                                                           \
    extern "C" int cg_update_##SUFFIX(void* x, void* r, const void* p, const void* a,           \
                                      long long L, const void* part_pap, int n_pap,             \
                                      const void* part_rz, int n_rz, double s, void* sc,        \
                                      void* part_rr, int nparts, void* stream) {                \
        if (elementwise_grid(L, nparts) < 0 || n_pap < 1 || n_rz < 1)                           \
            return (int)cudaErrorInvalidValue;                                                  \
        auto k = pairs_aligned<T>({x, r, p, a}) ? cg_update_kernel<T, true>                     \
                                                : cg_update_kernel<T, false>;                   \
        k<<<nparts, CG_THREADS, 0, (cudaStream_t)stream>>>(                                     \
            (T*)x, (T*)r, (const T*)p, (const T*)a, L, (const T*)part_pap, n_pap,               \
            (const T*)part_rz, n_rz, (T)s, (T*)sc, (T*)part_rr);                                \
        return (int)cudaGetLastError();                                                         \
    }                                                                                           \
    extern "C" int cg_precond_##SUFFIX(const void* r, void* z, const void* prec, long long sj,  \
                                       long long sa, long long sb, int nb, int bs, int rows,    \
                                       int q, long long si, long long sc, double s,             \
                                       void* part_rz, int nparts, void* stream) {               \
        return launch_precond<T>((const T*)r, (T*)z, (const T*)prec, sj, sa, sb, nb, bs, rows,  \
                                 q, si, sc, s, (T*)part_rz, nparts, stream);                    \
    }                                                                                           \
    extern "C" int cg_direction_##SUFFIX(const void* z, void* p, long long L,                   \
                                         const void* part_rz, int n_rz, const void* sc,         \
                                         const void* part_rr, int n_rr, void* flag,             \
                                         int nparts, void* stream) {                            \
        if (elementwise_grid(L, nparts) < 0 || n_rz < 1 || n_rr < 1)                            \
            return (int)cudaErrorInvalidValue;                                                  \
        auto k = pairs_aligned<T>({z, p}) ? cg_direction_kernel<T, true>                        \
                                          : cg_direction_kernel<T, false>;                      \
        k<<<nparts, CG_THREADS, 0, (cudaStream_t)stream>>>(                                     \
            (const T*)z, (T*)p, L, (const T*)part_rz, n_rz, (const T*)sc, (const T*)part_rr,    \
            n_rr, (int*)flag);                                                                  \
        return (int)cudaGetLastError();                                                         \
    }

CG_DEFINE(f64, double)
CG_DEFINE(f32, float)

// One CG iteration after the product a: the four launches above, in order,
// from one call (the host's cost of an iteration is one call, not four).
#define CG_DEFINE_ITERATION(SUFFIX)                                                             \
    extern "C" int cg_iteration_##SUFFIX(                                                       \
        void* x, void* r, void* z, void* p, const void* a, long long L, void* part_pap,        \
        void* part_rr, int n_el, void* part_rz, int n_rz, void* sc, void* flag, double s,       \
        const void* prec, long long sj, long long sa, long long sb, int nb, int bs, int rows,   \
        int q, long long si, long long sci, void* stream) {                                     \
        int err = cg_pap_##SUFFIX(p, a, L, part_pap, n_el, stream);                             \
        if (err == 0)                                                                           \
            err = cg_update_##SUFFIX(x, r, p, a, L, part_pap, n_el, part_rz, n_rz, s, sc,       \
                                     part_rr, n_el, stream);                                    \
        if (err == 0)                                                                           \
            err = cg_precond_##SUFFIX(r, z, prec, sj, sa, sb, nb, bs, rows, q, si, sci, s,      \
                                      part_rz, n_rz, stream);                                   \
        if (err == 0)                                                                           \
            err = cg_direction_##SUFFIX(z, p, L, part_rz, n_rz, sc, part_rr, n_el, flag, n_el,  \
                                        stream);                                                \
        return err;                                                                             \
    }

CG_DEFINE_ITERATION(f64)
CG_DEFINE_ITERATION(f32)

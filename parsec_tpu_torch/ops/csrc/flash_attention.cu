// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_fa_kernel` of the reference package
// (parsec_tpu/ops/flash_attention.py:44-101, launched at :165). It computes
// the same function: softmax attention over (S, H, dh) operands with an
// online softmax kept in f32, an optional causal mask on global positions
// (qpos >= kpos, both from 0, also when Sk != S) that skips wholly-future
// KV tiles and keeps p = 0 on masked entries (finite -1e30 mask value), and
// the finalize o = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)).
//
// Design. The TPU kernel walks the KV blocks as the innermost, sequential
// grid axis and carries (acc, m, l) in VMEM scratch between grid steps.
// On the GPU, CTAs run in parallel and in no order, so one CTA owns one
// (head, 64-row query block) and walks the KV tiles in a loop of its own.
// Q, K and V tiles are staged to shared memory as f32 (bf16 inputs are
// widened on load); the running max and sum live in shared memory and the
// accumulator (64 x dh) lives in registers, 32 floats per thread. The
// TPU-only layout work — padding dh to 128 lanes and broadcasting lse
// over 128 lanes — is dropped: the kernel reads (S, H, dh) in place and
// writes lse as (S, H).
//
// Bound. Per head the kernel does 4*S*Sk*dh flops (about half of that
// under causal) and moves (S + 2*Sk)*dh inputs and S*dh + S outputs, so at
// dh = 128 it has ~30+ flops per byte and is bound by arithmetic. This
// first version multiplies with FP32 FMAs on the CUDA cores, so its
// ceiling is the FP32 peak (67 TFLOP/s on an H100 SXM at 700 W); the
// tensor-core bound it should later approach is 495 TFLOP/s in TF32 or
// 989 TFLOP/s in bf16 (wgmma with TMA-fed tiles, a later PR). Shared
// memory rows are padded by one float so the column walks of Q and K are
// free of bank conflicts.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 64;          // keys per KV tile
constexpr int NTHREADS = 256;   // 16 x 16 threads
constexpr float NEG = -1e30f;   // finite -inf (same convention as the TPU kernel)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int DHP>
constexpr size_t smem_bytes() {
    return sizeof(float) * (size_t)(BQ * (DHP + 1) + BK * (DHP + 1) + BK * DHP +
                                    BQ * (BK + 1) + 3 * BQ);
}

// DHP: head dim padded up to 32, 64 or 128 (zero-filled in shared memory)
template <typename T, int DHP>
__global__ void __launch_bounds__(NTHREADS)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, int S, int Sk, int H, int dh,
              float scale, int causal)
{
    constexpr int LDQ = DHP + 1;   // padded row stride of Q and K tiles
    constexpr int LDP = BK + 1;    // padded row stride of the score tile
    constexpr int NJ = DHP / 16;   // accumulator columns per thread
    extern __shared__ float smem[];
    float* sQ = smem;                  // BQ x LDQ
    float* sK = sQ + BQ * LDQ;         // BK x LDQ
    float* sV = sK + BK * LDQ;         // BK x DHP
    float* sP = sV + BK * DHP;         // BQ x LDP: scores, then probabilities
    float* sM = sP + BQ * LDP;         // running max per row
    float* sL = sM + BQ;               // running sum per row
    float* sC = sL + BQ;               // this tile's correction per row

    const int h = blockIdx.y;
    const int q0 = blockIdx.x * BQ;
    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const long rs = (long)H * dh;      // row stride of (S, H, dh)

    for (int idx = tid; idx < BQ * DHP; idx += NTHREADS) {
        const int r = idx / DHP, d = idx % DHP;
        float x = 0.f;
        if (q0 + r < S && d < dh) x = to_f32(q[(q0 + r) * rs + (long)h * dh + d]);
        sQ[r * LDQ + d] = x;
    }
    if (tid < BQ) { sM[tid] = NEG; sL[tid] = 0.f; }

    float acc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

    // causal: keys past the block's last query row are all in the future
    const int kend = causal ? min(Sk, q0 + BQ) : Sk;
    for (int k0 = 0; k0 < kend; k0 += BK) {
        __syncthreads();   // previous tile's readers are done with sK/sV/sP
        for (int idx = tid; idx < BK * DHP; idx += NTHREADS) {
            const int r = idx / DHP, d = idx % DHP;
            float kx = 0.f, vx = 0.f;
            if (k0 + r < Sk && d < dh) {
                const long off = (k0 + r) * rs + (long)h * dh + d;
                kx = to_f32(k[off]);
                vx = to_f32(v[off]);
            }
            sK[r * LDQ + d] = kx;
            sV[r * DHP + d] = vx;
        }
        __syncthreads();

        // scores for rows ty + 16*i, keys tx + 16*j
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int d = 0; d < DHP; ++d) {
            float qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * LDQ + d];
#pragma unroll
            for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * LDQ + d];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = ty + 16 * i;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = tx + 16 * j;
                const int kpos = k0 + c;
                float x = s[i][j] * scale;
                if (kpos >= Sk || (causal && q0 + r < kpos)) x = NEG;
                sP[r * LDP + c] = x;
            }
        }
        __syncthreads();

        // online softmax: four threads (adjacent lanes) per row, 16 keys each
        {
            const int r = tid >> 2, part = tid & 3;
            float* row = sP + r * LDP + part * 16;
            float mx = NEG;
#pragma unroll
            for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_prev = sM[r];
            const float m_new = fmaxf(m_prev, mx);
            float sum = 0.f;
#pragma unroll
            for (int c = 0; c < 16; ++c) {
                const float x = row[c];
                // masked entries keep p exactly zero (rows masked so far
                // have m_new == NEG, where exp would give 1)
                const float p = x > 0.5f * NEG ? expf(x - m_new) : 0.f;
                row[c] = p;
                sum += p;
            }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            __syncwarp();   // every lane has read sM[r] before it changes
            if (part == 0) {
                const float corr = expf(m_prev - m_new);
                sC[r] = corr;
                sL[r] = sL[r] * corr + sum;
                sM[r] = m_new;
            }
        }
        __syncthreads();

        // acc = acc * corr + P V for rows ty + 16*i, columns tx + 16*j
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float corr = sC[ty + 16 * i];
#pragma unroll
            for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
        }
        const int cend = min(BK, kend - k0);
        for (int c = 0; c < cend; ++c) {
            float pv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * LDP + c];
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const float vv = sV[c * DHP + tx + 16 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
            }
        }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (q0 + r >= S) continue;
        const float l = fmaxf(sL[r], 1e-30f);
        const float inv = 1.f / l;
        T* orow = o + (q0 + r) * rs + (long)h * dh;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int d = tx + 16 * j;
            if (d < dh) store(orow + d, acc[i][j] * inv);
        }
        if (tx == 0) lse[(long)(q0 + r) * H + h] = sM[r] + logf(l);
    }
}

template <typename T, int DHP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int S, int Sk, int H, int dh, float scale,
                   int causal, cudaStream_t stream)
{
    constexpr size_t smem = smem_bytes<DHP>();
    cudaError_t err = cudaFuncSetAttribute(
        fa_fwd_kernel<T, DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((S + BQ - 1) / BQ, H);
    fa_fwd_kernel<T, DHP><<<grid, NTHREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o),
        static_cast<float*>(lse), S, Sk, H, dh, scale, causal);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v, void* o,
                        void* lse, int S, int Sk, int H, int dh, float scale,
                        int causal, cudaStream_t stream)
{
    if (dh <= 32) return launch<T, 32>(q, k, v, o, lse, S, Sk, H, dh, scale, causal, stream);
    if (dh <= 64) return launch<T, 64>(q, k, v, o, lse, S, Sk, H, dh, scale, causal, stream);
    return launch<T, 128>(q, k, v, o, lse, S, Sk, H, dh, scale, causal, stream);
}

}  // namespace

extern "C" {

// q (S, H, dh), k and v (Sk, H, dh), o (S, H, dh) in the input type,
// lse (S, H) float32; all contiguous on the current device.
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int fa_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
           int S, int Sk, int H, int dh, float scale, int causal, int dtype,
           void* stream)
{
    if (S <= 0 || Sk <= 0 || H <= 0 || dh <= 0 || dh > 128 || H > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return (int)dispatch_dh<float>(q, k, v, o, lse, S, Sk, H, dh, scale, causal, st);
    if (dtype == 1)
        return (int)dispatch_dh<__nv_bfloat16>(q, k, v, o, lse, S, Sk, H, dh, scale, causal, st);
    return (int)cudaErrorInvalidValue;
}

const char* fa_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

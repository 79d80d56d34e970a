// Posterior local alignment on Hopper: the whole forward + backward DP
// of one alignment lane in one warp, bound as the XLA FFI target
// "consent_posterior_summary" for the CUDA platform.
//
// Contract: ops/align.py posterior_summary, bit for bit (see
// align_core.h for the cell arithmetic and the slot geometry).
//
// Layout.  One warp per lane; the lane's S = 32 * P DP slots are held
// in registers, P consecutive slots per thread.  The band (consensus)
// or the padded ref width (stitch) is the slot count.  A full DP wider
// than the register variants (S > 1024, windows above ~880 bases) runs
// align_wide_kernel instead, with the row in shared memory.  Per row:
//   * the vertical (banded) or diagonal (full) neighbour is one slot
//     over: one shuffle of the edge slot;
//   * the horizontal gap term E is an exclusive windowed max-plus scan
//     across the slots: a scan inside the thread, then shuffles of
//     thread maxima (unbounded) or of the few threads a short window
//     reaches (the consensus gap cap);
//   * the match-entering scores hm stream to the hm staging buffer as
//     int16 (the only O(Lq * S) traffic); the backward sweep reads
//     them back one row ahead of use.
// The backward sweep folds the match posterior into per-column first /
// last matched rows in shared memory; the epilogue derives the aligned
// base and the packed insertion window from the query in shared memory
// and writes all per-column fields once.
//
// Build (ops/gpu_align.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -I<jax.ffi.include_dir()> align_kernel.cu
#include <cuda_runtime.h>

#include <cstdint>

#include "align_core.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;
using namespace consent_align;

namespace {

constexpr int WARPS = 4;               // lanes per block, at most
constexpr unsigned FULL = 0xffffffffu;

// Value of the thread d lanes back along the scan direction: lower
// lanes for a prefix scan (DIR > 0), higher lanes for a suffix scan.
template <int DIR>
__device__ __forceinline__ int32_t from_back(int32_t v, int d) {
  return DIR > 0 ? __shfl_up_sync(FULL, v, d) : __shfl_down_sync(FULL, v, d);
}

// Exclusive windowed max over the warp's slots, in scan order.
// DIR > 0: out[s] = max x[k] for k in [s - WIN, s - 1];
// DIR < 0: out[s] = max x[k] for k in [s + 1, s + WIN];
// NEG where the range is empty, WIN == 0 for an unbounded window.
// Thread `lane` holds slots lane*P .. lane*P + P - 1 in ascending order;
// a suffix scan walks them mirrored (rank 31 - lane, index P-1-u).
template <int P, int WIN, int DIR>
__device__ __forceinline__ void excl_scan(const int32_t (&x)[P],
                                          int32_t (&out)[P], int lane) {
  const int rank = DIR > 0 ? lane : 31 - lane;
  auto X = [&](int u) { return x[DIR > 0 ? u : P - 1 - u]; };
  auto O = [&](int u) -> int32_t& { return out[DIR > 0 ? u : P - 1 - u]; };
  if constexpr (WIN == 0 || WIN >= 32 * P) {
    int32_t run = NEG;
#pragma unroll
    for (int u = 0; u < P; ++u) {
      O(u) = run;
      run = imax(run, X(u));
    }
    int32_t inc = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = from_back<DIR>(inc, d);
      if (rank >= d) inc = imax(inc, y);
    }
    int32_t before = from_back<DIR>(inc, 1);
    if (rank == 0) before = NEG;
#pragma unroll
    for (int u = 0; u < P; ++u) O(u) = imax(O(u), before);
  } else {
    // suf[v] = max of this thread's X(v .. P-1)
    int32_t suf[P];
    suf[P - 1] = X(P - 1);
#pragma unroll
    for (int v = P - 2; v >= 0; --v) suf[v] = imax(X(v), suf[v + 1]);
    // whole threads a window reaches: back[d] = max M over d threads
    constexpr int DMAX = (WIN + P - 1) / P;
    int32_t back[DMAX];
    back[0] = NEG;
#pragma unroll
    for (int d = 1; d < DMAX; ++d) {
      int32_t y = from_back<DIR>(suf[0], d);
      if (rank < d) y = NEG;
      back[d] = imax(back[d - 1], y);
    }
#pragma unroll
    for (int u = 0; u < P; ++u) {
      int32_t acc = NEG;
#pragma unroll
      for (int k = (u - WIN > 0 ? u - WIN : 0); k < u; ++k)
        acc = imax(acc, X(k));
      if (u - WIN < 0) {
        // the window starts in thread rank - dm, at its slot v
        const int dm = (WIN - u + P - 1) / P;
        const int v = u - WIN + dm * P;
        int32_t y = from_back<DIR>(suf[v], dm);
        if (rank < dm) y = NEG;
        acc = imax(acc, imax(back[dm - 1], y));
      }
      O(u) = acc;
    }
  }
}

__device__ __forceinline__ uint32_t pack16(int32_t lo, int32_t hi) {
  return (uint32_t)(uint16_t)(int16_t)lo |
         ((uint32_t)(uint16_t)(int16_t)hi << 16);
}

__device__ __forceinline__ int32_t lo16(uint32_t w) {
  return (int32_t)(int16_t)(w & 0xffffu);
}

__device__ __forceinline__ int32_t hi16(uint32_t w) {
  return (int32_t)(int16_t)(w >> 16);
}

// Shared memory of one warp: query, ref, first / last matched row.
__host__ __device__ inline int64_t warp_smem_bytes(int32_t Lq, int32_t Lr) {
  const int64_t qb = (Lq + 15) & ~15, rb = (Lr + 15) & ~15;
  return qb + rb + 4 * rb;
}

// align_wide_kernel adds the H rows (two) and the F row of S slots and
// the carried gap-scan tail.
constexpr int WIDE_TAIL = 32;
__host__ __device__ inline int64_t wide_smem_bytes(int32_t Lq, int32_t Lr,
                                                   int32_t S) {
  return warp_smem_bytes(Lq, Lr) + 4 * (3 * (int64_t)S + WIDE_TAIL);
}

__device__ __forceinline__ int32_t warp_max(int32_t v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = imax(v, __shfl_xor_sync(FULL, v, d));
  return v;
}

template <int P, int WIN, bool BANDED>
__global__ void __launch_bounds__(WARPS * 32)
    align_kernel(const uint8_t* __restrict__ q,
                 const int32_t* __restrict__ q_len,
                 const uint8_t* __restrict__ r,
                 const int32_t* __restrict__ r_len,
                 const int32_t* __restrict__ d0, int64_t N, int32_t Lq,
                 int32_t Lr, Scoring sc, int32_t* __restrict__ opt_out,
                 int32_t* __restrict__ i_first,
                 int32_t* __restrict__ i_last, int32_t* __restrict__ base,
                 int32_t* __restrict__ ins, int16_t* __restrict__ hm_all,
                 int32_t /* S, fixed by P here */) {
  constexpr int S = 32 * P;
  constexpr int V = P / 4;  // 8-byte words of hm per thread and row
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t n = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (n >= N) return;

  const int64_t qb = (Lq + 15) & ~15, rb = (Lr + 15) & ~15;
  uint8_t* q_s = smem + warp * warp_smem_bytes(Lq, Lr);
  uint8_t* r_s = q_s + qb;
  int16_t* if_s = reinterpret_cast<int16_t*>(r_s + rb);
  int16_t* il_s = if_s + rb;
  for (int k = lane; k < Lq; k += 32) q_s[k] = q[n * Lq + k];
  for (int k = lane; k < Lr; k += 32) {
    r_s[k] = r[n * Lr + k];
    il_s[k] = -1;
  }
  __syncwarp();

  const int32_t qlen = q_len[n];
  const int32_t qn = imin(imax(qlen, 0), Lq);
  const Geometry g =
      lane_geometry(BANDED ? S : 0, BANDED ? d0[n] : 0, r_len[n], Lr);
  const int s0 = lane * P;
  int16_t* hm_lane = hm_all + n * (int64_t)Lq * S + s0;

  // full DP: each thread's columns are fixed, so is its ref slice
  int32_t rc[BANDED ? 1 : P];
  bool rok[BANDED ? 1 : P];
  if constexpr (!BANDED) {
#pragma unroll
    for (int u = 0; u < P; ++u) {
      rok[u] = g.valid(s0 + u);
      rc[u] = rok[u] ? r_s[s0 + u] : 0;
    }
  }
  auto sub_at = [&](uint8_t qc, int32_t i, int u) {
    if constexpr (BANDED) {
      const int32_t j = g.col(i, s0 + u);
      const bool ok = g.valid(j);
      return sub_score(qc, ok ? r_s[j] : 0, ok, sc);
    } else {
      return sub_score(qc, (uint8_t)rc[u], rok[u], sc);
    }
  };

  // ---------------- forward ----------------
  int32_t h[P], f[P];
#pragma unroll
  for (int u = 0; u < P; ++u) {
    h[u] = 0;
    f[u] = NEG;
  }
  int32_t best = 0;
  for (int32_t i = 0; i < qn; ++i) {
    const uint8_t qc = q_s[i];
    int32_t hd[P], hv[P], fv[P];
    if constexpr (BANDED) {
      int32_t hn = __shfl_down_sync(FULL, h[0], 1);
      int32_t fnx = __shfl_down_sync(FULL, f[0], 1);
      if (lane == 31) hn = fnx = NEG;
#pragma unroll
      for (int u = 0; u < P; ++u) {
        hd[u] = h[u];
        hv[u] = u + 1 < P ? h[u + 1] : hn;
        fv[u] = u + 1 < P ? f[u + 1] : fnx;
      }
    } else {
      int32_t hp = __shfl_up_sync(FULL, h[P - 1], 1);
      if (lane == 0) hp = 0;
#pragma unroll
      for (int u = 0; u < P; ++u) {
        hd[u] = u ? h[u - 1] : hp;
        hv[u] = h[u];
        fv[u] = f[u];
      }
    }
    int32_t hm[P], ht[P], x[P], pe[P];
#pragma unroll
    for (int u = 0; u < P; ++u) {
      ht[u] = fwd_cell(hd[u], hv[u], fv[u], sub_at(qc, i, u), sc, &hm[u],
                       &f[u]);
      best = imax(best, hm[u]);
      x[u] = ht[u] + (s0 + u) * sc.ext;
    }
    excl_scan<P, WIN, 1>(x, pe, lane);
#pragma unroll
    for (int u = 0; u < P; ++u) h[u] = fwd_finish(ht[u], pe[u], s0 + u, sc);
    uint2* dst = reinterpret_cast<uint2*>(hm_lane + (int64_t)i * S);
#pragma unroll
    for (int v = 0; v < V; ++v)
      dst[v] = make_uint2(pack16(hm[4 * v], hm[4 * v + 1]),
                          pack16(hm[4 * v + 2], hm[4 * v + 3]));
  }
  const int32_t opt = warp_max(best);

  // ---------------- backward + posterior fold ----------------
#pragma unroll
  for (int u = 0; u < P; ++u) {
    h[u] = 0;   // BH
    f[u] = NEG; // BF
  }
  uint2 next[V];
  if (qn > 0) {
    const uint2* src =
        reinterpret_cast<const uint2*>(hm_lane + (int64_t)(qn - 1) * S);
#pragma unroll
    for (int v = 0; v < V; ++v) next[v] = src[v];
  }
  for (int32_t i = qn - 1; i >= 0; --i) {
    int32_t hm[P];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      hm[4 * v] = lo16(next[v].x);
      hm[4 * v + 1] = hi16(next[v].x);
      hm[4 * v + 2] = lo16(next[v].y);
      hm[4 * v + 3] = hi16(next[v].y);
    }
    if (i > 0) {
      const uint2* src =
          reinterpret_cast<const uint2*>(hm_lane + (int64_t)(i - 1) * S);
#pragma unroll
      for (int v = 0; v < V; ++v) next[v] = src[v];
    }
    const uint8_t qc = q_s[i];
    int32_t bd[P], bv[P], bfv[P];
    if constexpr (BANDED) {
      int32_t bp = __shfl_up_sync(FULL, h[P - 1], 1);
      int32_t bfp = __shfl_up_sync(FULL, f[P - 1], 1);
      if (lane == 0) bp = bfp = NEG;
#pragma unroll
      for (int u = 0; u < P; ++u) {
        bd[u] = h[u];
        bv[u] = u ? h[u - 1] : bp;
        bfv[u] = u ? f[u - 1] : bfp;
      }
    } else {
      int32_t bn = __shfl_down_sync(FULL, h[0], 1);
      if (lane == 31) bn = 0;
#pragma unroll
      for (int u = 0; u < P; ++u) {
        bd[u] = u + 1 < P ? h[u + 1] : bn;
        bv[u] = h[u];
        bfv[u] = f[u];
      }
    }
    int32_t bt[P], y[P], se[P];
    bool hit[P];
    bool any = false;
#pragma unroll
    for (int u = 0; u < P; ++u) {
      hit[u] = g.valid(g.col(i, s0 + u)) && on_path(hm[u], bd[u], opt);
      any |= hit[u];
      bt[u] = bwd_cell(bd[u], bv[u], bfv[u], sub_at(qc, i, u), sc, &f[u]);
      y[u] = bt[u] - (s0 + u) * sc.ext;
    }
    excl_scan<P, WIN, -1>(y, se, lane);
#pragma unroll
    for (int u = 0; u < P; ++u) h[u] = bwd_finish(bt[u], se[u], s0 + u, sc);
    if (__any_sync(FULL, any)) {
      // rows descend: i_first converges to the smallest matched row,
      // i_last keeps the first (largest) one
#pragma unroll
      for (int u = 0; u < P; ++u) {
        if (hit[u]) {
          const int32_t j = g.col(i, s0 + u);
          if_s[j] = (int16_t)i;
          if (il_s[j] < 0) il_s[j] = (int16_t)i;
        }
      }
      __syncwarp();
    }
  }
  __syncwarp();

  // ---------------- per-column outputs ----------------
  for (int32_t j = lane; j < Lr; j += 32) {
    const int32_t il = il_s[j];
    const int64_t o = n * Lr + j;
    i_first[o] = il >= 0 ? (int32_t)if_s[j] : Lq;
    i_last[o] = il;
    base[o] = il >= 0 ? (int32_t)q_s[il] : 0;
    ins[o] = il >= 0 ? ins_pack(q_s, qlen, Lq, il) : 0;
  }
  if (lane == 0) opt_out[n] = opt;
}


// Full DP of S > 1024 slots (S a multiple of 128): the recurrence of
// align_kernel<P, WIN, false> with the row in shared memory instead of
// registers — H of the previous and the current row, F in place — swept
// in chunks of 128 slots, 4 per thread.  The gap scan runs inside each
// chunk as excl_scan does and carries into the next chunk in scan
// order: the running max of all earlier inputs (unbounded), or the
// WIDE_TAIL inputs next to the chunk (a window of at most 32).
template <int WIN>
__global__ void __launch_bounds__(WARPS * 32)
    align_wide_kernel(const uint8_t* __restrict__ q,
                      const int32_t* __restrict__ q_len,
                      const uint8_t* __restrict__ r,
                      const int32_t* __restrict__ r_len,
                      const int32_t* __restrict__ /* d0, unused */,
                      int64_t N, int32_t Lq, int32_t Lr, Scoring sc,
                      int32_t* __restrict__ opt_out,
                      int32_t* __restrict__ i_first,
                      int32_t* __restrict__ i_last,
                      int32_t* __restrict__ base, int32_t* __restrict__ ins,
                      int16_t* __restrict__ hm_all, int32_t S) {
  constexpr int P = 4, C = 32 * P, T = WIDE_TAIL;
  static_assert(WIN <= T, "the carried tail must cover the gap window");
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t n = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (n >= N) return;

  const int64_t qb = (Lq + 15) & ~15, rb = (Lr + 15) & ~15;
  uint8_t* q_s = smem + warp * wide_smem_bytes(Lq, Lr, S);
  uint8_t* r_s = q_s + qb;
  int16_t* if_s = reinterpret_cast<int16_t*>(r_s + rb);
  int16_t* il_s = if_s + rb;
  int32_t* hp = reinterpret_cast<int32_t*>(il_s + rb);  // previous row
  int32_t* hc = hp + S;                                 // current row
  int32_t* f_s = hc + S;
  int32_t* tail = f_s + S;
  for (int k = lane; k < Lq; k += 32) q_s[k] = q[n * Lq + k];
  for (int k = lane; k < Lr; k += 32) {
    r_s[k] = r[n * Lr + k];
    il_s[k] = -1;
  }
  for (int k = lane; k < S; k += 32) {
    hp[k] = 0;
    f_s[k] = NEG;
  }
  __syncwarp();

  const int32_t qlen = q_len[n];
  const int32_t qn = imin(imax(qlen, 0), Lq);
  const Geometry g = lane_geometry(0, 0, r_len[n], Lr);
  int16_t* hm_lane = hm_all + n * (int64_t)Lq * S;
  auto sub_at = [&](uint8_t qc, int s) {
    const bool ok = g.valid(s);
    return sub_score(qc, ok ? r_s[s] : 0, ok, sc);
  };

  // ---------------- forward ----------------
  int32_t best = 0;
  for (int32_t i = 0; i < qn; ++i) {
    const uint8_t qc = q_s[i];
    int32_t carry = NEG;
    for (int c = 0; c < S; c += C) {
      const int s0 = c + lane * P;
      int32_t hm[P], ht[P], x[P], pe[P];
#pragma unroll
      for (int u = 0; u < P; ++u) {
        const int s = s0 + u;
        ht[u] = fwd_cell(s ? hp[s - 1] : 0, hp[s], f_s[s], sub_at(qc, s), sc,
                         &hm[u], &f_s[s]);
        best = imax(best, hm[u]);
        x[u] = ht[u] + s * sc.ext;
      }
      excl_scan<P, WIN, 1>(x, pe, lane);
      if constexpr (WIN == 0) {
#pragma unroll
        for (int u = 0; u < P; ++u) pe[u] = imax(pe[u], carry);
        carry = imax(carry, warp_max(imax(imax(x[0], x[1]),
                                          imax(x[2], x[3]))));
      } else {
        // the window of a slot near the chunk's start reaches into the
        // previous chunk's last T inputs
        if (c > 0) {
#pragma unroll
          for (int u = 0; u < P; ++u)
            for (int k = s0 + u - WIN; k < c; ++k)
              pe[u] = imax(pe[u], tail[k - (c - T)]);
        }
        __syncwarp();
        if (lane >= 32 - T / P) {
#pragma unroll
          for (int u = 0; u < P; ++u) tail[(lane - (32 - T / P)) * P + u] = x[u];
        }
        __syncwarp();
      }
#pragma unroll
      for (int u = 0; u < P; ++u) hc[s0 + u] = fwd_finish(ht[u], pe[u], s0 + u, sc);
      *reinterpret_cast<uint2*>(hm_lane + (int64_t)i * S + s0) =
          make_uint2(pack16(hm[0], hm[1]), pack16(hm[2], hm[3]));
    }
    __syncwarp();
    int32_t* t = hp;
    hp = hc;
    hc = t;
  }
  const int32_t opt = warp_max(best);

  // ---------------- backward + posterior fold ----------------
  for (int k = lane; k < S; k += 32) {
    hp[k] = 0;   // BH
    f_s[k] = NEG; // BF
  }
  __syncwarp();
  for (int32_t i = qn - 1; i >= 0; --i) {
    const uint8_t qc = q_s[i];
    int32_t carry = NEG;
    for (int c = S - C; c >= 0; c -= C) {
      const int s0 = c + lane * P;
      const uint2 w =
          *reinterpret_cast<const uint2*>(hm_lane + (int64_t)i * S + s0);
      const int32_t hm[P] = {lo16(w.x), hi16(w.x), lo16(w.y), hi16(w.y)};
      int32_t bt[P], y[P], se[P];
      bool hit[P];
      bool any = false;
#pragma unroll
      for (int u = 0; u < P; ++u) {
        const int s = s0 + u;
        const int32_t bd = s + 1 < S ? hp[s + 1] : 0;
        hit[u] = g.valid(s) && on_path(hm[u], bd, opt);
        any |= hit[u];
        bt[u] = bwd_cell(bd, hp[s], f_s[s], sub_at(qc, s), sc, &f_s[s]);
        y[u] = bt[u] - s * sc.ext;
      }
      excl_scan<P, WIN, -1>(y, se, lane);
      if constexpr (WIN == 0) {
#pragma unroll
        for (int u = 0; u < P; ++u) se[u] = imax(se[u], carry);
        carry = imax(carry, warp_max(imax(imax(y[0], y[1]),
                                          imax(y[2], y[3]))));
      } else {
        // ... or, in the backward sweep, the next chunk's first T inputs
        if (c + C < S) {
#pragma unroll
          for (int u = 0; u < P; ++u)
            for (int k = c + C; k <= s0 + u + WIN; ++k)
              se[u] = imax(se[u], tail[k - (c + C)]);
        }
        __syncwarp();
        if (lane < T / P) {
#pragma unroll
          for (int u = 0; u < P; ++u) tail[lane * P + u] = y[u];
        }
        __syncwarp();
      }
#pragma unroll
      for (int u = 0; u < P; ++u) hc[s0 + u] = bwd_finish(bt[u], se[u], s0 + u, sc);
      if (__any_sync(FULL, any)) {
#pragma unroll
        for (int u = 0; u < P; ++u) {
          if (hit[u]) {
            const int32_t j = s0 + u;
            if_s[j] = (int16_t)i;
            if (il_s[j] < 0) il_s[j] = (int16_t)i;
          }
        }
      }
    }
    __syncwarp();
    int32_t* t = hp;
    hp = hc;
    hc = t;
  }

  // ---------------- per-column outputs ----------------
  for (int32_t j = lane; j < Lr; j += 32) {
    const int32_t il = il_s[j];
    const int64_t o = n * Lr + j;
    i_first[o] = il >= 0 ? (int32_t)if_s[j] : Lq;
    i_last[o] = il;
    base[o] = il >= 0 ? (int32_t)q_s[il] : 0;
    ins[o] = il >= 0 ? ins_pack(q_s, qlen, Lq, il) : 0;
  }
  if (lane == 0) opt_out[n] = opt;
}

using KernelFn = void (*)(const uint8_t*, const int32_t*, const uint8_t*,
                          const int32_t*, const int32_t*, int64_t, int32_t,
                          int32_t, Scoring, int32_t*, int32_t*, int32_t*,
                          int32_t*, int32_t*, int16_t*, int32_t);

struct Variant {
  KernelFn fn;
  bool wide;   // align_wide_kernel: the row in shared memory
};

// The compiled (banded, slots per thread, gap window) variants: the
// consensus band of 128 or 256 slots with gap caps up to 32, and the
// full DP in registers up to 1024 columns, exact or with the consensus
// gap cap; wider full DPs, exact or with a gap window up to 32, run
// align_wide_kernel.
Variant pick(bool banded, int P, int win) {
  if (!banded && P > 32 && P % 4 == 0) {
    switch (win) {
      case 0: return {align_wide_kernel<0>, true};
      case 8: return {align_wide_kernel<8>, true};
      case 16: return {align_wide_kernel<16>, true};
      case 32: return {align_wide_kernel<32>, true};
      default: return {nullptr, false};
    }
  }
#define CONSENT_CASE(B, PP, W) \
  if (banded == B && P == PP && win == W) return {align_kernel<PP, W, B>, false};
  CONSENT_CASE(true, 4, 0) CONSENT_CASE(true, 4, 8)
  CONSENT_CASE(true, 4, 16) CONSENT_CASE(true, 4, 32)
  CONSENT_CASE(true, 8, 0) CONSENT_CASE(true, 8, 8)
  CONSENT_CASE(true, 8, 16) CONSENT_CASE(true, 8, 32)
  CONSENT_CASE(false, 4, 0) CONSENT_CASE(false, 8, 0)
  CONSENT_CASE(false, 12, 0) CONSENT_CASE(false, 16, 0)
  CONSENT_CASE(false, 20, 0) CONSENT_CASE(false, 24, 0)
  CONSENT_CASE(false, 28, 0) CONSENT_CASE(false, 32, 0)
  CONSENT_CASE(false, 4, 16) CONSENT_CASE(false, 8, 16)
  CONSENT_CASE(false, 12, 16) CONSENT_CASE(false, 16, 16)
  CONSENT_CASE(false, 20, 16)
#undef CONSENT_CASE
  return {nullptr, false};
}

ffi::Error AlignCuda(cudaStream_t stream, ffi::Buffer<ffi::U8> q,
                     ffi::Buffer<ffi::S32> q_len, ffi::Buffer<ffi::U8> r,
                     ffi::Buffer<ffi::S32> r_len, ffi::Buffer<ffi::S32> d0,
                     ffi::ResultBuffer<ffi::S32> opt,
                     ffi::ResultBuffer<ffi::S32> i_first,
                     ffi::ResultBuffer<ffi::S32> i_last,
                     ffi::ResultBuffer<ffi::S32> base,
                     ffi::ResultBuffer<ffi::S32> ins,
                     ffi::ResultBuffer<ffi::S16> hm, int32_t band,
                     int32_t window, int32_t match, int32_t mismatch,
                     int32_t gap_open, int32_t gap_extend) {
  const auto qd = q.dimensions();
  const int64_t N = qd[0];
  const int32_t Lq = (int32_t)qd[1];
  const int32_t Lr = (int32_t)r.dimensions()[1];
  const int32_t S = (int32_t)hm->dimensions()[2];
  if (N == 0) return ffi::Error::Success();
  const Variant var = S % 32 == 0 ? pick(band > 0, S / 32, window)
                                  : Variant{nullptr, false};
  KernelFn fn = var.fn;
  if (fn == nullptr || (band > 0 && band != S))
    return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                      "consent_posterior_summary: no kernel for this "
                      "band / width / gap window");
  // as many lanes per block as shared memory holds, up to WARPS
  int dev = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const int64_t per_warp =
      var.wide ? wide_smem_bytes(Lq, Lr, S) : warp_smem_bytes(Lq, Lr);
  const int64_t warps = per_warp * WARPS <= smem_max
                            ? WARPS
                            : (per_warp <= smem_max ? smem_max / per_warp : 0);
  if (warps == 0)
    return ffi::Error(ffi::ErrorCode::kResourceExhausted,
                      "consent_posterior_summary: one lane's rows exceed "
                      "the shared memory of a block");
  const int64_t smem = warps * per_warp;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess)
      return ffi::Error(ffi::ErrorCode::kResourceExhausted,
                        cudaGetErrorString(e));
  }
  const Scoring sc{match, mismatch, gap_open, gap_extend};
  const int64_t blocks = (N + warps - 1) / warps;
  fn<<<(unsigned)blocks, (unsigned)(warps * 32), smem, stream>>>(
      q.typed_data(), q_len.typed_data(), r.typed_data(),
      r_len.typed_data(), d0.typed_data(), N, Lq, Lr, sc,
      opt->typed_data(), i_first->typed_data(), i_last->typed_data(),
      base->typed_data(), ins->typed_data(), hm->typed_data(), S);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess)
    return ffi::Error(ffi::ErrorCode::kInternal, cudaGetErrorString(e));
  return ffi::Error::Success();
}

}  // namespace

// Whether a (banded, slots per thread, window) variant is compiled in;
// the Python wrapper asks before it lowers a call.
extern "C" int consent_align_supported(int banded, int P, int window) {
  return pick(banded != 0, P, window).fn != nullptr;
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(ConsentPosteriorSummary, AlignCuda,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S16>>()
                                  .Attr<int32_t>("band")
                                  .Attr<int32_t>("window")
                                  .Attr<int32_t>("match")
                                  .Attr<int32_t>("mismatch")
                                  .Attr<int32_t>("gap_open")
                                  .Attr<int32_t>("gap_extend"));

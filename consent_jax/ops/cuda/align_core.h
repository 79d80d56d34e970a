// Cell arithmetic and lane geometry of the posterior aligner, shared by
// the CUDA kernel (align_kernel.cu) and its host model (align_host.cc).
//
// Contract: ops/align.py posterior_summary, bit for bit, in all six
// PosteriorSummary fields.  Scores are integers that never leave the
// int16 range (NEG = -2^14, |score| <= 2 * width), so the int32
// arithmetic here is value-equal to the int16 XLA recurrence.
//
// A lane's DP row is held in S "slots":
//   * full DP (band == 0): slot s is ref column j = s; S >= Lr, and the
//     slots past Lr are ordinary out-of-ref cells;
//   * banded (band == B): slot s of row i is ref column
//     j = i + s + d0 - B/2, so the diagonal predecessor (i-1, j-1) is
//     the same slot of the previous row and the vertical one (i-1, j)
//     is slot s+1.  Slots left of column 0 hold H = 0 in the forward
//     sweep and slots right of the ref hold BH = 0 in the backward
//     sweep, which is what the XLA form's zero pads give.
// Cells outside the valid rectangle score NEG (no match can start or
// continue there); every in-band cell floors at 0, so the E/F values
// that reach an out-of-band or out-of-range neighbour never win a max.
#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define CA_HD __host__ __device__ __forceinline__
#else
#define CA_HD inline
#endif

namespace consent_align {

constexpr int32_t NEG = -(1 << 14);   // ops/align.py NEG
constexpr int INS_PACK = 16;           // ops/align.py INS_PACK

CA_HD int32_t imax(int32_t a, int32_t b) { return a > b ? a : b; }
CA_HD int32_t imin(int32_t a, int32_t b) { return a < b ? a : b; }

struct Scoring {
  int32_t match, mismatch, open, ext;
};

// Where a lane's slots sit on its ref, and which cells are valid.
struct Geometry {
  bool banded;
  int32_t shift;   // banded: column of slot 0 in row 0 (d0 - band/2)
  int32_t jlo;     // valid columns are [jlo, jhi)
  int32_t jhi;

  CA_HD int32_t col(int32_t i, int32_t s) const {
    return banded ? i + s + shift : s;
  }
  CA_HD bool valid(int32_t j) const { return j >= jlo && j < jhi; }
};

// XLA's validity mask: j < r_len and, when banded, the kernel column
// j - d0 inside [0, Lr).
CA_HD Geometry lane_geometry(int32_t band, int32_t d0, int32_t r_len,
                             int32_t Lr) {
  Geometry g;
  g.banded = band > 0;
  int32_t rl = imin(imax(r_len, 0), Lr);
  if (g.banded) {
    g.shift = d0 - band / 2;
    g.jlo = imax(0, d0);
    // Lr + d0 in 64 bits: d0 comes from the caller unchecked
    int64_t hi = (int64_t)Lr + d0;
    g.jhi = (int32_t)(hi < rl ? (hi < 0 ? 0 : hi) : rl);
  } else {
    g.shift = 0;
    g.jlo = 0;
    g.jhi = rl;
  }
  return g;
}

CA_HD int32_t sub_score(uint8_t qc, uint8_t rc, bool ok,
                        const Scoring& sc) {
  return ok ? (qc == rc ? sc.match : sc.mismatch) : NEG;
}

// Forward cell before the horizontal term: hd = H(i-1, j-1),
// hv/fv = H/F(i-1, j).  Writes hm (match-entering score) and F; returns
// the gap-free score Ht.
CA_HD int32_t fwd_cell(int32_t hd, int32_t hv, int32_t fv, int32_t sub,
                       const Scoring& sc, int32_t* hm, int32_t* f) {
  *hm = hd + sub;
  *f = imax(hv - sc.open, fv - sc.ext);
  return imax(imax(*hm, *f), 0);
}

// H from Ht and the exclusive windowed max pe of (Ht(k) + k*ext) over
// the slots k left of s: E(s) = pe - s*ext - (open - ext).
CA_HD int32_t fwd_finish(int32_t ht, int32_t pe, int32_t s,
                         const Scoring& sc) {
  return imax(ht, pe - s * sc.ext - (sc.open - sc.ext));
}

// Backward cell: bd = BH(i+1, j+1), bv/bfv = BH/BF(i+1, j).
CA_HD int32_t bwd_cell(int32_t bd, int32_t bv, int32_t bfv, int32_t sub,
                       const Scoring& sc, int32_t* bf) {
  *bf = imax(bv - sc.open, bfv - sc.ext);
  return imax(imax(sub + bd, *bf), 0);
}

// BH from Bt and the exclusive windowed max se of (Bt(k) - k*ext) over
// the slots right of s.
CA_HD int32_t bwd_finish(int32_t bt, int32_t se, int32_t s,
                         const Scoring& sc) {
  return imax(bt, se + s * sc.ext - (sc.open - sc.ext));
}

// (i, j) is matched on an optimal local alignment.
CA_HD bool on_path(int32_t hm, int32_t bd, int32_t opt) {
  return opt > 0 && hm > NEG / 2 && hm + bd == opt;
}

// ops/align.py derive_base_ins for one matched column: the 16 query
// bases after i_last, 2 bits each, summed with int32 wraparound as XLA
// does (offsets at or past q_len count 0).
CA_HD int32_t ins_pack(const uint8_t* q, int32_t q_len, int32_t Lq,
                       int32_t il) {
  uint32_t acc = 0;
  for (int k = 0; k < INS_PACK; ++k) {
    int32_t g = il + 1 + k;
    uint32_t b = g < q_len ? q[imin(g, Lq - 1)] : 0;
    acc += b << (2 * k);
  }
  return (int32_t)acc;
}

}  // namespace consent_align

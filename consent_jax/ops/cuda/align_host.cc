// Host model of the posterior-alignment kernel, bound as an XLA FFI
// target for the CPU platform.
//
// It runs the CUDA kernel's recurrence (align_core.h, same slot
// geometry, same hm staging buffer, same result layout) one lane at a
// time with plain loops where the kernel uses warp shuffles.  The CPU
// tests call ops/gpu_align.py's wrapper against this target, which
// checks the wrapper and the recurrence against ops/align.py
// posterior_summary on machines without a GPU.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC -I<jax.ffi.include_dir()>
#include <algorithm>
#include <cstdint>
#include <vector>

#include "align_core.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;
using namespace consent_align;

namespace {

// pe[s] = max over k in [s - win, s - 1] (k >= 0) of x[k]; NEG if
// empty.  win == 0: unbounded.
void excl_prefix_max(const std::vector<int32_t>& x, int32_t win,
                     std::vector<int32_t>& pe) {
  const int S = (int)x.size();
  for (int s = 0; s < S; ++s) {
    int lo = win ? std::max(0, s - win) : 0;
    int32_t m = NEG;
    for (int k = lo; k < s; ++k) m = imax(m, x[k]);
    pe[s] = m;
  }
}

// se[s] = max over k in [s + 1, s + win] (k < S) of y[k]; NEG if empty.
void excl_suffix_max(const std::vector<int32_t>& y, int32_t win,
                     std::vector<int32_t>& se) {
  const int S = (int)y.size();
  for (int s = 0; s < S; ++s) {
    int hi = win ? std::min(S - 1, s + win) : S - 1;
    int32_t m = NEG;
    for (int k = s + 1; k <= hi; ++k) m = imax(m, y[k]);
    se[s] = m;
  }
}

void align_lane(const uint8_t* q, int32_t q_len, const uint8_t* r,
                int32_t r_len, int32_t d0, int32_t Lq, int32_t Lr,
                int32_t S, int32_t band, int32_t win, const Scoring& sc,
                int16_t* hm_all, int32_t* opt_out, int32_t* i_first,
                int32_t* i_last, int32_t* base, int32_t* ins) {
  const Geometry g = lane_geometry(band, d0, r_len, Lr);
  const int32_t qn = imin(imax(q_len, 0), Lq);
  std::vector<int32_t> h(S, 0), f(S, NEG), hn(S), fn(S), x(S), pe(S);
  int32_t best = 0;
  for (int32_t i = 0; i < qn; ++i) {
    int16_t* hm_row = hm_all + (int64_t)i * S;
    for (int32_t s = 0; s < S; ++s) {
      int32_t hd, hv, fv;
      if (g.banded) {
        hd = h[s];
        hv = s + 1 < S ? h[s + 1] : NEG;
        fv = s + 1 < S ? f[s + 1] : NEG;
      } else {
        hd = s > 0 ? h[s - 1] : 0;
        hv = h[s];
        fv = f[s];
      }
      const int32_t j = g.col(i, s);
      const bool ok = g.valid(j);
      const int32_t sub = sub_score(q[i], ok ? r[j] : 0, ok, sc);
      int32_t hm;
      const int32_t ht = fwd_cell(hd, hv, fv, sub, sc, &hm, &fn[s]);
      hm_row[s] = (int16_t)hm;
      best = imax(best, hm);
      hn[s] = ht;
      x[s] = ht + s * sc.ext;
    }
    excl_prefix_max(x, win, pe);
    for (int32_t s = 0; s < S; ++s) hn[s] = fwd_finish(hn[s], pe[s], s, sc);
    std::swap(h, hn);
    std::swap(f, fn);
  }
  const int32_t opt = best;
  *opt_out = opt;

  std::vector<int32_t> ifs(Lr, Lq), ils(Lr, -1);
  std::vector<int32_t>& bh = h;
  std::vector<int32_t>& bf = f;
  std::fill(bh.begin(), bh.end(), 0);
  std::fill(bf.begin(), bf.end(), NEG);
  for (int32_t i = qn - 1; i >= 0; --i) {
    const int16_t* hm_row = hm_all + (int64_t)i * S;
    for (int32_t s = 0; s < S; ++s) {
      int32_t bd, bv, bfv;
      if (g.banded) {
        bd = bh[s];
        bv = s > 0 ? bh[s - 1] : NEG;
        bfv = s > 0 ? bf[s - 1] : NEG;
      } else {
        bd = s + 1 < S ? bh[s + 1] : 0;
        bv = bh[s];
        bfv = bf[s];
      }
      const int32_t j = g.col(i, s);
      const bool ok = g.valid(j);
      if (on_path(hm_row[s], bd, opt)) {
        ifs[j] = i;
        if (ils[j] < 0) ils[j] = i;
      }
      const int32_t sub = sub_score(q[i], ok ? r[j] : 0, ok, sc);
      const int32_t bt = bwd_cell(bd, bv, bfv, sub, sc, &fn[s]);
      hn[s] = bt;
      x[s] = bt - s * sc.ext;
    }
    excl_suffix_max(x, win, pe);
    for (int32_t s = 0; s < S; ++s) hn[s] = bwd_finish(hn[s], pe[s], s, sc);
    std::swap(bh, hn);
    std::swap(bf, fn);
  }
  for (int32_t j = 0; j < Lr; ++j) {
    const int32_t il = ils[j];
    i_first[j] = il >= 0 ? ifs[j] : Lq;
    i_last[j] = il;
    base[j] = il >= 0 ? q[il] : 0;
    ins[j] = il >= 0 ? ins_pack(q, q_len, Lq, il) : 0;
  }
}

ffi::Error AlignHost(ffi::Buffer<ffi::U8> q, ffi::Buffer<ffi::S32> q_len,
                     ffi::Buffer<ffi::U8> r, ffi::Buffer<ffi::S32> r_len,
                     ffi::Buffer<ffi::S32> d0,
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
  const Scoring sc{match, mismatch, gap_open, gap_extend};
  for (int64_t n = 0; n < N; ++n) {
    align_lane(q.typed_data() + n * Lq, q_len.typed_data()[n],
               r.typed_data() + n * Lr, r_len.typed_data()[n],
               d0.typed_data()[n], Lq, Lr, S, band, window, sc,
               hm->typed_data() + n * (int64_t)Lq * S,
               opt->typed_data() + n, i_first->typed_data() + n * Lr,
               i_last->typed_data() + n * Lr, base->typed_data() + n * Lr,
               ins->typed_data() + n * Lr);
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(ConsentPosteriorSummary, AlignHost,
                              ffi::Ffi::Bind()
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

// Banded separable bicubic-antialias resize (host hot path of the video
// pipeline; the PyTorch port's own copy of the JAX package's
// `video/native/resize.cpp`, the same code). Tap weights/starts come from
// Python (video/resize.py resize_taps — the same values as the dense
// torchvision-semantics matrix), so this computes the identical float32
// single-rounding sum with ~2·support terms per output instead of a dense
// in_size-wide contraction.
//
// Pass order matches video/resize.resize_frames_device: vertical (H) first,
// then horizontal (W), one final round-half-even (nearbyint, default FE mode —
// numpy/torch round semantics) + clip to uint8.
//
// Built on first use by video/resize.py with g++ -O3 (no dependencies).

#include <cmath>
#include <cstdint>
#include <vector>

// Fused CLIP-normalize + Qwen2-VL patchify: (T, C, H, W) float32 frames →
// (grid_t·grid_h·grid_w, C·tp·ps²) float32 patch rows, the exact
// reshape/transpose order of Qwen2VLImageProcessor._preprocess (see
// models/processor.py::patchify_video, which this accelerates: the numpy
// path is three full-array passes — rescale, normalize, 9-D transpose copy —
// where one fused pass suffices on the 1-vCPU eval host). T is padded to a
// multiple of tp by repeating the last frame (t index clamp). mean/std are
// per-channel; rescale is 1/255 (or 1.0 for pre-rescaled frames);
// do_normalize=0 skips the mean/std step. Value math matches numpy order:
// (v*rescale - mean[c]) / std[c], float32 throughout.
extern "C" int t1_patchify(
    const float* in, int64_t T, int64_t C, int64_t H, int64_t W,
    float* out, int64_t tp, int64_t ps, int64_t ms,
    const float* mean, const float* stdv, float rescale, int do_normalize) {
  if (H % (ps * ms) != 0 || W % (ps * ms) != 0 || C > 8) return 1;
  const int64_t gt = (T + tp - 1) / tp;
  const int64_t gh = H / ps, gw = W / ps;
  const int64_t ghm = gh / ms, gwm = gw / ms;
  const int64_t cols = C * tp * ps * ps;
  float mc[8], sc[8];
  for (int64_t c = 0; c < C; ++c) {
    mc[c] = do_normalize ? mean[c] : 0.f;
    sc[c] = do_normalize ? stdv[c] : 1.f;
  }
  // output-major: row p = ((it·ghm + ih)·gwm + iw)·ms² + ihm·ms + iwm,
  // col = ((c·tp + itp)·ps + ip)·ps + iq; the innermost iq run reads ps
  // contiguous input floats.
  for (int64_t it = 0; it < gt; ++it)
    for (int64_t ih = 0; ih < ghm; ++ih)
      for (int64_t iw = 0; iw < gwm; ++iw)
        for (int64_t ihm = 0; ihm < ms; ++ihm)
          for (int64_t iwm = 0; iwm < ms; ++iwm) {
            const int64_t p = (((it * ghm + ih) * gwm + iw) * ms + ihm) * ms + iwm;
            float* orow = out + p * cols;
            for (int64_t c = 0; c < C; ++c) {
              const float m = mc[c], s = sc[c];
              for (int64_t itp = 0; itp < tp; ++itp) {
                int64_t t = it * tp + itp;
                if (t >= T) t = T - 1;  // odd-T last-frame repeat
                const float* fin = in + (t * C + c) * H * W;
                for (int64_t ip = 0; ip < ps; ++ip) {
                  const int64_t h = (ih * ms + ihm) * ps + ip;
                  const float* src = fin + h * W + (iw * ms + iwm) * ps;
                  float* dst = orow + ((c * tp + itp) * ps + ip) * ps;
                  for (int64_t iq = 0; iq < ps; ++iq)
                    dst[iq] = (src[iq] * rescale - m) / s;
                }
              }
            }
          }
  return 0;
}

extern "C" int t1_resize_frames(
    const uint8_t* in, int64_t T, int64_t H, int64_t W, int64_t C,
    uint8_t* out, int64_t OH, int64_t OW,
    const int32_t* starts_h, const float* taps_h, int64_t Kh,
    const int32_t* starts_w, const float* taps_w, int64_t Kw) {
  const int64_t WC = W * C;
  std::vector<float> tmp(static_cast<size_t>(OH) * WC);  // one frame's h-pass
  std::vector<float> acc(static_cast<size_t>(C));
  for (int64_t t = 0; t < T; ++t) {
    const uint8_t* fin = in + t * H * WC;
    for (int64_t o = 0; o < OH; ++o) {  // vertical pass
      float* row = tmp.data() + o * WC;
      for (int64_t j = 0; j < WC; ++j) row[j] = 0.f;
      for (int64_t k = 0; k < Kh; ++k) {
        const float w = taps_h[o * Kh + k];
        if (w == 0.f) continue;  // zero-padded band edge: exact no-op
        const uint8_t* src = fin + static_cast<int64_t>(starts_h[o] + k) * WC;
        for (int64_t j = 0; j < WC; ++j) row[j] += w * static_cast<float>(src[j]);
      }
    }
    uint8_t* fout = out + t * OH * OW * C;
    for (int64_t o = 0; o < OH; ++o) {  // horizontal pass + round/clip/store
      const float* row = tmp.data() + o * WC;
      uint8_t* orow = fout + o * OW * C;
      for (int64_t p = 0; p < OW; ++p) {
        for (int64_t c = 0; c < C; ++c) acc[c] = 0.f;
        for (int64_t k = 0; k < Kw; ++k) {
          const float w = taps_w[p * Kw + k];
          if (w == 0.f) continue;
          const float* src = row + static_cast<int64_t>(starts_w[p] + k) * C;
          for (int64_t c = 0; c < C; ++c) acc[c] += w * src[c];
        }
        for (int64_t c = 0; c < C; ++c) {
          float v = nearbyintf(acc[c]);
          v = v < 0.f ? 0.f : (v > 255.f ? 255.f : v);
          orow[p * C + c] = static_cast<uint8_t>(v);
        }
      }
    }
  }
  return 0;
}

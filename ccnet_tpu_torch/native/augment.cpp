// ccnet_tpu native data runtime: fused augmentation + collation kernel.
//
// The TPU-host-side equivalent of the reference's native data path (torch's
// C++ DataLoader core + cv2): for each sample, random-scale (cv2 INTER_LINEAR
// half-pixel semantics), labelId->trainId LUT, pad, crop, mirror and BGR-mean
// subtraction are FUSED — only the crop_h x crop_w output window is ever
// computed, instead of resizing the whole image and then cropping (an up-to-
// ~8x saving at scale 2.1 on 1024x2048 inputs). OpenMP-parallel over
// (batch x rows); consumes decoded uint8 images directly (4x less host
// memory traffic than the float pipeline).
//
// Sampling semantics are identical to ccnet_tpu/data/preprocess.py
// (device_augment), which is itself verified against the cv2 chain in
// tests/test_data.py. Invalid (beyond scaled extent) pixels produce 0
// post-mean-subtraction for images and ignore_label for labels, matching
// the reference's padding (dataset/datasets.py:185-199).

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

inline float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace

extern "C" {

// images:  B * H0 * W0 * 3   uint8 (BGR, as decoded by cv2/libpng)
// labels:  B * H0 * W0       uint8 (raw labelIds; pass identity LUT if
//                            already trainIds)
// lut:     256               uint8 labelId -> trainId map
// scales:  B                 float, e.g. 0.7 .. 2.1
// offs:    B * 2             int (oy, ox) crop offsets in scaled space
// flips:   B                 uint8 (0/1) horizontal mirror
// mean:    3                 float BGR mean
// out_images: B * crop_h * crop_w * 3  float32
// out_labels: B * crop_h * crop_w      int32
void ccnet_augment_batch(const uint8_t* images, const uint8_t* labels,
                         const uint8_t* lut, int B, int H0, int W0,
                         int crop_h, int crop_w, const float* scales,
                         const int* offs, const uint8_t* flips,
                         const float* mean, int ignore_label,
                         float* out_images, int32_t* out_labels) {
#pragma omp parallel for collapse(2) schedule(static)
  for (int b = 0; b < B; ++b) {
    for (int i = 0; i < crop_h; ++i) {
      const float f = scales[b];
      const int sH = (int)std::lround(H0 * f);
      const int sW = (int)std::lround(W0 * f);
      const int oy = offs[2 * b], ox = offs[2 * b + 1];
      const bool flip = flips[b] != 0;
      const float ry = (float)H0 / (float)sH;
      const float rx = (float)W0 / (float)sW;
      const uint8_t* img = images + (size_t)b * H0 * W0 * 3;
      const uint8_t* lbl = labels + (size_t)b * H0 * W0;
      float* oimg = out_images + ((size_t)b * crop_h + i) * crop_w * 3;
      int32_t* olbl = out_labels + ((size_t)b * crop_h + i) * crop_w;

      const int ys = i + oy;
      const bool valid_y = ys < sH;
      // bilinear row setup (cv2 half-pixel centres)
      const float src_y = clampf((ys + 0.5f) * ry - 0.5f, 0.0f, (float)(H0 - 1));
      const int y_lo = (int)src_y;
      const int y_hi = std::min(y_lo + 1, H0 - 1);
      const float wy = src_y - (float)y_lo;
      // nearest row for the label
      const int ny = std::min((int)std::floor(ys * ry), H0 - 1);

      for (int j = 0; j < crop_w; ++j) {
        const int jj = flip ? (crop_w - 1 - j) : j;  // mirror the output
        const int xs = jj + ox;
        float* po = oimg + (size_t)j * 3;
        if (!valid_y || xs >= sW) {  // padded region
          po[0] = po[1] = po[2] = 0.0f;
          olbl[j] = ignore_label;
          continue;
        }
        const float src_x = clampf((xs + 0.5f) * rx - 0.5f, 0.0f, (float)(W0 - 1));
        const int x_lo = (int)src_x;
        const int x_hi = std::min(x_lo + 1, W0 - 1);
        const float wx = src_x - (float)x_lo;
        const uint8_t* p00 = img + ((size_t)y_lo * W0 + x_lo) * 3;
        const uint8_t* p01 = img + ((size_t)y_lo * W0 + x_hi) * 3;
        const uint8_t* p10 = img + ((size_t)y_hi * W0 + x_lo) * 3;
        const uint8_t* p11 = img + ((size_t)y_hi * W0 + x_hi) * 3;
        for (int c = 0; c < 3; ++c) {
          const float top = p00[c] + (p01[c] - p00[c]) * wx;
          const float bot = p10[c] + (p11[c] - p10[c]) * wx;
          po[c] = top + (bot - top) * wy - mean[c];
        }
        const int nx = std::min((int)std::floor(xs * rx), W0 - 1);
        olbl[j] = (int32_t)lut[lbl[(size_t)ny * W0 + nx]];
      }
    }
  }
}

// Wire-minimal variant: uint8 CROPS out, no mean subtraction (the device
// does the f32 widen + mean subtract — see data/preprocess.py
// finish_u8_crops). The image pad value is the rounded dataset mean so it
// lands at ~0 after the on-device subtract; labels pad to ignore_label.
// Same fused sampling as above: only the crop window is ever computed —
// up to ~8x less arithmetic than resize-whole-then-crop at scale 2.1.
//
// out_images: B * crop_h * crop_w * 3  uint8
// out_labels: B * crop_h * crop_w      uint8
void ccnet_augment_batch_u8(const uint8_t* images, const uint8_t* labels,
                            const uint8_t* lut, int B, int H0, int W0,
                            int crop_h, int crop_w, const float* scales,
                            const int* offs, const uint8_t* flips,
                            const uint8_t* pad_val, int ignore_label,
                            uint8_t* out_images, uint8_t* out_labels) {
#pragma omp parallel for collapse(2) schedule(static)
  for (int b = 0; b < B; ++b) {
    for (int i = 0; i < crop_h; ++i) {
      const float f = scales[b];
      const int sH = (int)std::lround(H0 * f);
      const int sW = (int)std::lround(W0 * f);
      const int oy = offs[2 * b], ox = offs[2 * b + 1];
      const bool flip = flips[b] != 0;
      const float ry = (float)H0 / (float)sH;
      const float rx = (float)W0 / (float)sW;
      // label nearest: cv2's exact arithmetic chain (double inv of the
      // double dst/src scale) -- reproduces INTER_NEAREST bit-exactly,
      // including its behaviour at integer tie points
      const double iry = 1.0 / ((double)sH / (double)H0);
      const double irx = 1.0 / ((double)sW / (double)W0);
      const uint8_t* img = images + (size_t)b * H0 * W0 * 3;
      const uint8_t* lbl = labels + (size_t)b * H0 * W0;
      uint8_t* oimg = out_images + ((size_t)b * crop_h + i) * crop_w * 3;
      uint8_t* olbl = out_labels + ((size_t)b * crop_h + i) * crop_w;

      const int ys = i + oy;
      const bool valid_y = ys < sH;
      const float src_y = clampf((ys + 0.5f) * ry - 0.5f, 0.0f, (float)(H0 - 1));
      const int y_lo = (int)src_y;
      const int y_hi = std::min(y_lo + 1, H0 - 1);
      const float wy = src_y - (float)y_lo;
      const int ny = std::min((int)std::floor(ys * iry), H0 - 1);

      for (int j = 0; j < crop_w; ++j) {
        const int jj = flip ? (crop_w - 1 - j) : j;
        const int xs = jj + ox;
        uint8_t* po = oimg + (size_t)j * 3;
        if (!valid_y || xs >= sW) {  // padded region
          po[0] = pad_val[0];
          po[1] = pad_val[1];
          po[2] = pad_val[2];
          olbl[j] = (uint8_t)ignore_label;
          continue;
        }
        const float src_x = clampf((xs + 0.5f) * rx - 0.5f, 0.0f, (float)(W0 - 1));
        const int x_lo = (int)src_x;
        const int x_hi = std::min(x_lo + 1, W0 - 1);
        const float wx = src_x - (float)x_lo;
        const uint8_t* p00 = img + ((size_t)y_lo * W0 + x_lo) * 3;
        const uint8_t* p01 = img + ((size_t)y_lo * W0 + x_hi) * 3;
        const uint8_t* p10 = img + ((size_t)y_hi * W0 + x_lo) * 3;
        const uint8_t* p11 = img + ((size_t)y_hi * W0 + x_hi) * 3;
        for (int c = 0; c < 3; ++c) {
          const float top = p00[c] + (p01[c] - p00[c]) * wx;
          const float bot = p10[c] + (p11[c] - p10[c]) * wx;
          const float v = top + (bot - top) * wy;
          po[c] = (uint8_t)clampf(std::lround(v), 0.0f, 255.0f);
        }
        const int nx = std::min((int)std::floor(xs * irx), W0 - 1);
        olbl[j] = lut[lbl[(size_t)ny * W0 + nx]];
      }
    }
  }
}

}  // extern "C"

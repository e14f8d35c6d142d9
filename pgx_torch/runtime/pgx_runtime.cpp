// pgx native runtime: host-side data-pipeline kernels (pgx_torch's copy of
// runtime/pgx_runtime.cpp, ABI 2: the same entry points and arithmetic).
//
// The reference's native host dependency is libvips (via pyvips,
// data/utils.py:10-21) plus JIT-compiled CUDA plugins (torch_utils/
// custom_ops.py).  On a TPU host the device math belongs to XLA/Pallas; the
// native-code seam that remains hot is the input pipeline: assembling
// uint8 batches, resizing between progressive-growth resolutions, and
// normalizing to [-1, 1] float32 without Python-loop overhead.  This
// library implements those, exposed through a C ABI consumed via ctypes
// (pgx_torch/native.py builds it with g++ at first use into build/).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>

extern "C" {

// uint8 [0,255] -> float32 [-1, 1].  Division (not reciprocal multiply):
// 255/127.5f == 2.0f exactly, so the range endpoint is exactly 1.0 and the
// result matches the numpy fallback bit-for-bit.
void normalize_u8_to_f32(const uint8_t* src, int64_t n, float* dst) {
    for (int64_t i = 0; i < n; ++i) {
        dst[i] = static_cast<float>(src[i]) / 127.5f - 1.0f;
    }
}

// Fused batch assembly: gather `bs` images by index from a (N, H, W, C)
// uint8 array and write normalized float32 — the steady-state hot path of
// ArrayDataset batching.
void gather_normalize(const uint8_t* images, const int64_t* idx, int64_t bs,
                      int64_t image_elems, float* out) {
    for (int64_t b = 0; b < bs; ++b) {
        const uint8_t* src = images + idx[b] * image_elems;
        float* dst = out + b * image_elems;
        for (int64_t i = 0; i < image_elems; ++i) {
            dst[i] = static_cast<float>(src[i]) / 127.5f - 1.0f;
        }
    }
}

// Batch bilinear resize (half-pixel centers, no antialias) of NHWC uint8.
// Used for per-stage dataset caches; matches torch/PIL-without-antialias
// semantics (the framework's canonical resize convention).
void resize_bilinear_u8(const uint8_t* src, int64_t n, int64_t h, int64_t w,
                        int64_t c, uint8_t* dst, int64_t oh, int64_t ow) {
    const float sy = static_cast<float>(h) / static_cast<float>(oh);
    const float sx = static_cast<float>(w) / static_cast<float>(ow);
    for (int64_t img = 0; img < n; ++img) {
        const uint8_t* s = src + img * h * w * c;
        uint8_t* d = dst + img * oh * ow * c;
        for (int64_t oy = 0; oy < oh; ++oy) {
            float fy = (static_cast<float>(oy) + 0.5f) * sy - 0.5f;
            fy = std::max(0.0f, std::min(fy, static_cast<float>(h - 1)));
            int64_t y0 = static_cast<int64_t>(fy);
            int64_t y1 = std::min(y0 + 1, h - 1);
            float ty = fy - static_cast<float>(y0);
            for (int64_t ox = 0; ox < ow; ++ox) {
                float fx = (static_cast<float>(ox) + 0.5f) * sx - 0.5f;
                fx = std::max(0.0f,
                              std::min(fx, static_cast<float>(w - 1)));
                int64_t x0 = static_cast<int64_t>(fx);
                int64_t x1 = std::min(x0 + 1, w - 1);
                float tx = fx - static_cast<float>(x0);
                for (int64_t ch = 0; ch < c; ++ch) {
                    float v00 = s[(y0 * w + x0) * c + ch];
                    float v01 = s[(y0 * w + x1) * c + ch];
                    float v10 = s[(y1 * w + x0) * c + ch];
                    float v11 = s[(y1 * w + x1) * c + ch];
                    float top = v00 + (v01 - v00) * tx;
                    float bot = v10 + (v11 - v10) * tx;
                    float val = top + (bot - top) * ty;
                    d[(oy * ow + ox) * c + ch] =
                        static_cast<uint8_t>(val + 0.5f);
                }
            }
        }
    }
}

// Box-filter (area) downsample by an integer factor — the antialiased
// choice for large downscales in dataset prep.
void resize_box_u8(const uint8_t* src, int64_t n, int64_t h, int64_t w,
                   int64_t c, uint8_t* dst, int64_t factor) {
    const int64_t oh = h / factor, ow = w / factor;
    const float inv = 1.0f / static_cast<float>(factor * factor);
    for (int64_t img = 0; img < n; ++img) {
        const uint8_t* s = src + img * h * w * c;
        uint8_t* d = dst + img * oh * ow * c;
        for (int64_t oy = 0; oy < oh; ++oy) {
            for (int64_t ox = 0; ox < ow; ++ox) {
                for (int64_t ch = 0; ch < c; ++ch) {
                    float acc = 0.0f;
                    for (int64_t ky = 0; ky < factor; ++ky) {
                        const uint8_t* row =
                            s + ((oy * factor + ky) * w + ox * factor) * c
                            + ch;
                        for (int64_t kx = 0; kx < factor; ++kx) {
                            acc += static_cast<float>(row[kx * c]);
                        }
                    }
                    d[(oy * ow + ox) * c + ch] =
                        static_cast<uint8_t>(acc * inv + 0.5f);
                }
            }
        }
    }
}

// NOTE: a crop_flip_u8 kernel used to live here but had no caller — the
// folder pipeline's crop/flip is a zero-copy numpy view whose one copy
// happens in the batch np.stack either way, so a C++ kernel buys nothing.

int pgx_runtime_abi_version() { return 2; }

}  // extern "C"

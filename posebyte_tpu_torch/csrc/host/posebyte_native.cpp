// PoseBYTE-TPU native host runtime: visualization rasterizer + CPU
// preprocessing reference.
//
// Native-code counterpart of the reference's host-side C++ layer
// (reference: src/utils/video_utils.cpp drawing, and the CPU letterbox
// reference in src/tensorrt/yolo_pose_engine.cpp:515-557). Implemented
// dependency-free (no OpenCV): Bresenham lines, filled circles, rects,
// a 5x7 bitmap font, and a bilinear letterbox that matches the device
// kernel's sampling exactly.
//
// Exposed as a C ABI consumed from Python via ctypes
// (posebyte_tpu_torch/utils/native.py, which builds it with g++ on first
// use). The same source as native/posebyte_native.cpp of the JAX package,
// so that both packages draw the same bytes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// Primitives: frames are uint8 HWC (BGR or RGB agnostic), row-major.
// ---------------------------------------------------------------------------

static inline void put_px(uint8_t* img, int W, int H, int x, int y,
                          const uint8_t rgb[3]) {
    if (x < 0 || y < 0 || x >= W || y >= H) return;
    uint8_t* p = img + (static_cast<int64_t>(y) * W + x) * 3;
    p[0] = rgb[0]; p[1] = rgb[1]; p[2] = rgb[2];
}

void pb_draw_line(uint8_t* img, int W, int H, int x0, int y0, int x1,
                  int y1, const uint8_t rgb[3], int thickness) {
    int dx = std::abs(x1 - x0), sx = x0 < x1 ? 1 : -1;
    int dy = -std::abs(y1 - y0), sy = y0 < y1 ? 1 : -1;
    int err = dx + dy;
    int r = thickness / 2;
    while (true) {
        for (int oy = -r; oy <= r; ++oy)
            for (int ox = -r; ox <= r; ++ox)
                put_px(img, W, H, x0 + ox, y0 + oy, rgb);
        if (x0 == x1 && y0 == y1) break;
        int e2 = 2 * err;
        if (e2 >= dy) { err += dy; x0 += sx; }
        if (e2 <= dx) { err += dx; y0 += sy; }
    }
}

void pb_draw_circle(uint8_t* img, int W, int H, int cx, int cy, int radius,
                    const uint8_t rgb[3]) {
    for (int y = -radius; y <= radius; ++y)
        for (int x = -radius; x <= radius; ++x)
            if (x * x + y * y <= radius * radius)
                put_px(img, W, H, cx + x, cy + y, rgb);
}

void pb_draw_rect(uint8_t* img, int W, int H, int x0, int y0, int x1,
                  int y1, const uint8_t rgb[3], int thickness) {
    pb_draw_line(img, W, H, x0, y0, x1, y0, rgb, thickness);
    pb_draw_line(img, W, H, x1, y0, x1, y1, rgb, thickness);
    pb_draw_line(img, W, H, x1, y1, x0, y1, rgb, thickness);
    pb_draw_line(img, W, H, x0, y1, x0, y0, rgb, thickness);
}

// 5x7 bitmap font covering the glyphs the overlay uses:
// digits, uppercase letters used in labels, ':', '.', ' ', '-'.
static const uint8_t FONT_DIGITS[10][7] = {
    {0x0E,0x11,0x13,0x15,0x19,0x11,0x0E}, // 0
    {0x04,0x0C,0x04,0x04,0x04,0x04,0x0E}, // 1
    {0x0E,0x11,0x01,0x02,0x04,0x08,0x1F}, // 2
    {0x1F,0x02,0x04,0x02,0x01,0x11,0x0E}, // 3
    {0x02,0x06,0x0A,0x12,0x1F,0x02,0x02}, // 4
    {0x1F,0x10,0x1E,0x01,0x01,0x11,0x0E}, // 5
    {0x06,0x08,0x10,0x1E,0x11,0x11,0x0E}, // 6
    {0x1F,0x01,0x02,0x04,0x08,0x08,0x08}, // 7
    {0x0E,0x11,0x11,0x0E,0x11,0x11,0x0E}, // 8
    {0x0E,0x11,0x11,0x0F,0x01,0x02,0x0C}, // 9
};
static const uint8_t FONT_I[7] = {0x0E,0x04,0x04,0x04,0x04,0x04,0x0E};
static const uint8_t FONT_D[7] = {0x1E,0x11,0x11,0x11,0x11,0x11,0x1E};
static const uint8_t FONT_F[7] = {0x1F,0x10,0x10,0x1E,0x10,0x10,0x10};
static const uint8_t FONT_P[7] = {0x1E,0x11,0x11,0x1E,0x10,0x10,0x10};
static const uint8_t FONT_S[7] = {0x0F,0x10,0x10,0x0E,0x01,0x01,0x1E};
static const uint8_t FONT_T[7] = {0x1F,0x04,0x04,0x04,0x04,0x04,0x04};
static const uint8_t FONT_R[7] = {0x1E,0x11,0x11,0x1E,0x14,0x12,0x11};
static const uint8_t FONT_A[7] = {0x0E,0x11,0x11,0x1F,0x11,0x11,0x11};
static const uint8_t FONT_C[7] = {0x0E,0x11,0x10,0x10,0x10,0x11,0x0E};
static const uint8_t FONT_K[7] = {0x11,0x12,0x14,0x18,0x14,0x12,0x11};
static const uint8_t FONT_M[7] = {0x11,0x1B,0x15,0x15,0x11,0x11,0x11};
static const uint8_t FONT_COLON[7] = {0x00,0x04,0x00,0x00,0x00,0x04,0x00};
static const uint8_t FONT_DOT[7] = {0x00,0x00,0x00,0x00,0x00,0x0C,0x0C};
static const uint8_t FONT_DASH[7] = {0x00,0x00,0x00,0x1F,0x00,0x00,0x00};

static const uint8_t* glyph_for(char c) {
    if (c >= '0' && c <= '9') return FONT_DIGITS[c - '0'];
    switch (c) {
        case 'I': return FONT_I;  case 'D': return FONT_D;
        case 'F': return FONT_F;  case 'P': return FONT_P;
        case 'S': return FONT_S;  case 'T': return FONT_T;
        case 'R': return FONT_R;  case 'A': return FONT_A;
        case 'C': return FONT_C;  case 'K': return FONT_K;
        case 'M': return FONT_M;  case ':': return FONT_COLON;
        case '.': return FONT_DOT; case '-': return FONT_DASH;
        default: return nullptr;   // space / unknown -> advance only
    }
}

void pb_draw_text(uint8_t* img, int W, int H, int x, int y,
                  const char* text, const uint8_t rgb[3], int scale) {
    int cx = x;
    for (const char* c = text; *c; ++c) {
        const uint8_t* g = glyph_for(*c);
        if (g) {
            for (int row = 0; row < 7; ++row)
                for (int col = 0; col < 5; ++col)
                    if (g[row] & (1 << (4 - col)))
                        for (int sy = 0; sy < scale; ++sy)
                            for (int sx = 0; sx < scale; ++sx)
                                put_px(img, W, H, cx + col * scale + sx,
                                       y + row * scale + sy, rgb);
        }
        cx += 6 * scale;
    }
}

// ---------------------------------------------------------------------------
// Skeleton drawing (reference: drawPose, video_utils.cpp:50-102)
// ---------------------------------------------------------------------------

void pb_draw_pose(uint8_t* img, int W, int H,
                  const float* keypoints,      // [17 * 3] x,y,conf
                  const int32_t* edges,        // [n_edges * 2]
                  int n_edges,
                  const uint8_t rgb[3],
                  float conf_thresh, int kp_radius, int line_thickness) {
    for (int e = 0; e < n_edges; ++e) {
        int a = edges[e * 2], b = edges[e * 2 + 1];
        if (keypoints[a * 3 + 2] > conf_thresh &&
            keypoints[b * 3 + 2] > conf_thresh) {
            pb_draw_line(img, W, H,
                         static_cast<int>(keypoints[a * 3]),
                         static_cast<int>(keypoints[a * 3 + 1]),
                         static_cast<int>(keypoints[b * 3]),
                         static_cast<int>(keypoints[b * 3 + 1]),
                         rgb, line_thickness);
        }
    }
    for (int k = 0; k < 17; ++k) {
        if (keypoints[k * 3 + 2] > conf_thresh) {
            pb_draw_circle(img, W, H,
                           static_cast<int>(keypoints[k * 3]),
                           static_cast<int>(keypoints[k * 3 + 1]),
                           kp_radius, rgb);
        }
    }
}

// Draw a full batch of tracks in one call (amortizes the FFI crossing).
// tracks: n * (id + score + bbox4 + 51) packed as float rows.
void pb_draw_tracks(uint8_t* img, int W, int H,
                    const float* packed, int n_tracks,
                    const int32_t* edges, int n_edges,
                    const uint8_t* palette, int palette_len,
                    float conf_thresh) {
    const int ROW = 1 + 1 + 4 + 51;
    for (int t = 0; t < n_tracks; ++t) {
        const float* row = packed + t * ROW;
        int id = static_cast<int>(row[0]);
        const uint8_t* rgb = palette + (id % palette_len) * 3;
        const float* bbox = row + 2;
        pb_draw_pose(img, W, H, row + 6, edges, n_edges, rgb, conf_thresh,
                     3, 2);
        pb_draw_rect(img, W, H, static_cast<int>(bbox[0]),
                     static_cast<int>(bbox[1]), static_cast<int>(bbox[2]),
                     static_cast<int>(bbox[3]), rgb, 2);
        char label[32];
        snprintf(label, sizeof(label), "ID:%d %.2f", id, row[1]);
        int ly = static_cast<int>(bbox[1]) - 12;
        pb_draw_text(img, W, H, static_cast<int>(bbox[0]),
                     ly < 2 ? 2 : ly, label, rgb, 1);
    }
}

// ---------------------------------------------------------------------------
// CPU letterbox reference (reference: preprocess.cu:19-83 semantics,
// and yolo_pose_engine.cpp:515-557 CPU fallback)
// ---------------------------------------------------------------------------

void pb_letterbox_cpu(const uint8_t* input, int in_w, int in_h,
                      float* output, int target, int bgr_to_rgb) {
    float scale = std::min(static_cast<float>(target) / in_w,
                           static_cast<float>(target) / in_h);
    int new_w = static_cast<int>(in_w * scale);
    int new_h = static_cast<int>(in_h * scale);
    int pad_x = (target - new_w) / 2;
    int pad_y = (target - new_h) / 2;
    const float gray = 114.0f / 255.0f;
    const int64_t plane = static_cast<int64_t>(target) * target;

    for (int ty = 0; ty < target; ++ty) {
        for (int tx = 0; tx < target; ++tx) {
            int64_t o = static_cast<int64_t>(ty) * target + tx;
            if (tx < pad_x || tx >= pad_x + new_w ||
                ty < pad_y || ty >= pad_y + new_h) {
                output[0 * plane + o] = gray;
                output[1 * plane + o] = gray;
                output[2 * plane + o] = gray;
                continue;
            }
            float sx = std::min(std::max((tx - pad_x) / scale, 0.0f),
                                in_w - 1.001f);
            float sy = std::min(std::max((ty - pad_y) / scale, 0.0f),
                                in_h - 1.001f);
            int x0 = static_cast<int>(sx), y0 = static_cast<int>(sy);
            int x1 = std::min(x0 + 1, in_w - 1);
            int y1 = std::min(y0 + 1, in_h - 1);
            float wx = sx - x0, wy = sy - y0;
            for (int c = 0; c < 3; ++c) {
                float v00 = input[(static_cast<int64_t>(y0) * in_w + x0) * 3 + c];
                float v01 = input[(static_cast<int64_t>(y0) * in_w + x1) * 3 + c];
                float v10 = input[(static_cast<int64_t>(y1) * in_w + x0) * 3 + c];
                float v11 = input[(static_cast<int64_t>(y1) * in_w + x1) * 3 + c];
                float v = (1 - wx) * (1 - wy) * v00 + wx * (1 - wy) * v01 +
                          (1 - wx) * wy * v10 + wx * wy * v11;
                int oc = bgr_to_rgb ? 2 - c : c;
                output[oc * plane + o] = v / 255.0f;
            }
        }
    }
}

}  // extern "C"

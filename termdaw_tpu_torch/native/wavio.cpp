// Carried over from termdaw_tpu/native/wavio.cpp, every function whole, so
// that the port imports nothing of termdaw_tpu.
//
// Native WAV sample packing/unpacking fast paths.
//
// The reference's IO sits in native Rust crates (hound for WAV,
// Cargo.toml:15); here the hot byte-level transforms are C++ behind ctypes
// (termdaw_tpu_torch/native/__init__.py), with numpy fallbacks in
// termdaw_tpu_torch/fileio/wav.py. Functions are plain C ABI.
//
// Build: no Makefile; the loader compiles this file and packets.cpp at
// first use into termdaw_tpu_torch/build/libtermdaw_native-<hash>.so.

#include <cstdint>
#include <cstring>
#include <cmath>

extern "C" {

// little-endian signed 24-bit -> int32 (sign-extended)
void unpack24(const uint8_t* src, int64_t n, int32_t* dst) {
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* p = src + i * 3;
        int32_t v = (int32_t)p[0] | ((int32_t)p[1] << 8) | ((int32_t)p[2] << 16);
        if (v & 0x800000) v -= 0x1000000;
        dst[i] = v;
    }
}

// int32 (within 24-bit range) -> little-endian 24-bit
void pack24(const int32_t* src, int64_t n, uint8_t* dst) {
    for (int64_t i = 0; i < n; ++i) {
        uint32_t v = (uint32_t)src[i];
        uint8_t* p = dst + i * 3;
        p[0] = v & 0xff;
        p[1] = (v >> 8) & 0xff;
        p[2] = (v >> 16) & 0xff;
    }
}

// float32 * amplitude -> int16, truncate toward zero, saturate
void quantize16(const float* src, int64_t n, float amplitude, int16_t* dst) {
    for (int64_t i = 0; i < n; ++i) {
        float v = src[i] * amplitude;
        if (v > 32767.0f) v = 32767.0f;
        if (v < -32768.0f) v = -32768.0f;
        dst[i] = (int16_t)v;  // C cast truncates toward zero
    }
}

// float32 * amplitude -> int32, truncate toward zero, saturate
void quantize32(const float* src, int64_t n, double amplitude, int32_t* dst) {
    for (int64_t i = 0; i < n; ++i) {
        double v = (double)src[i] * amplitude;
        if (v > 2147483647.0) v = 2147483647.0;
        if (v < -2147483648.0) v = -2147483648.0;
        dst[i] = (int32_t)v;
    }
}

// planar stereo -> interleaved
void interleave2(const float* l, const float* r, int64_t n, float* dst) {
    for (int64_t i = 0; i < n; ++i) {
        dst[2 * i] = l[i];
        dst[2 * i + 1] = r[i];
    }
}

// interleaved stereo -> planar
void deinterleave2(const float* src, int64_t n, float* l, float* r) {
    for (int64_t i = 0; i < n; ++i) {
        l[i] = src[2 * i];
        r[i] = src[2 * i + 1];
    }
}

}  // extern "C"

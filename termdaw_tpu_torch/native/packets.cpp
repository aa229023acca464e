// Carried over from termdaw_tpu/native/packets.cpp, the scanner whole, so
// that the port imports nothing of termdaw_tpu; built with wavio.cpp by
// termdaw_tpu_torch/native/__init__.py.
//
// Native floww-packet frame scanner.
//
// The stream workflow decodes length-framed binary packets from stdin
// (format: termdaw_tpu_torch/fileio/packets.py). This scanner finds complete
// frame boundaries in a byte buffer so the Python layer can slice without
// re-parsing partial frames byte-by-byte.
//
// Returns the number of complete frames found; writes each frame's
// (offset, length) into out_spans (capacity `max_frames` pairs). A
// negative return value flags a malformed stream:
//   -1 unknown packet kind, -2 absurd declared size.

#include <cstdint>
#include <cstring>

static const uint8_t KIND_EVENTS = 0x01;
static const uint8_t KIND_TEXT = 0x02;
static const uint32_t MAX_REASONABLE = 1u << 28;  // 256 MiB guard

extern "C" {

int64_t scan_frames(const uint8_t* buf, int64_t len, int64_t* out_spans,
                    int64_t max_frames) {
    int64_t pos = 0;
    int64_t count = 0;
    while (pos < len && count < max_frames) {
        uint8_t kind = buf[pos];
        int64_t frame_len;
        if (kind == KIND_EVENTS) {
            if (pos + 3 > len) break;
            uint16_t name_len;
            std::memcpy(&name_len, buf + pos + 1, 2);
            int64_t hdr = 3 + (int64_t)name_len;
            if (pos + hdr + 4 > len) break;
            uint32_t n_events;
            std::memcpy(&n_events, buf + pos + hdr, 4);
            if (n_events > MAX_REASONABLE / 16) return -2;
            frame_len = hdr + 4 + (int64_t)n_events * 16;
        } else if (kind == KIND_TEXT) {
            if (pos + 5 > len) break;
            uint32_t text_len;
            std::memcpy(&text_len, buf + pos + 1, 4);
            if (text_len > MAX_REASONABLE) return -2;
            frame_len = 5 + (int64_t)text_len;
        } else {
            return -1;
        }
        if (pos + frame_len > len) break;
        out_spans[count * 2] = pos;
        out_spans[count * 2 + 1] = frame_len;
        pos += frame_len;
        ++count;
    }
    return count;
}

}  // extern "C"

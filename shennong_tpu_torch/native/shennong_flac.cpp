// Native FLAC decoder for the host IO runtime.
//
// The reference decodes FLAC through the ffmpeg binary (pydub,
// shennong/audio.py:276-281); this image carries no ffmpeg, so the
// framework ships its own decoder. Scope: the full FLAC subset seen
// in practice — CONSTANT / VERBATIM / FIXED / LPC subframes, Rice and
// Rice2 partitioned residuals, wasted bits, independent and
// left/right/mid-side stereo decorrelation, 8..32-bit samples. CRCs
// are not verified (decode is validated sample-exact against the
// original WAV in the tests).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 (see native/__init__.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
    const uint8_t* data;
    size_t size;
    size_t pos = 0;   // byte position
    int bit = 0;      // bit position within byte (msb first)
    bool error = false;

    bool aligned_ok(size_t nbytes) const { return pos + nbytes <= size; }

    uint64_t read_bits(int n) {
        uint64_t value = 0;
        while (n > 0) {
            if (pos >= size) { error = true; return 0; }
            int avail = 8 - bit;
            int take = n < avail ? n : avail;
            int shift = avail - take;
            uint64_t chunk = (data[pos] >> shift) & ((1u << take) - 1);
            value = (value << take) | chunk;
            bit += take;
            if (bit == 8) { bit = 0; ++pos; }
            n -= take;
        }
        return value;
    }

    int64_t read_signed(int n) {
        uint64_t raw = read_bits(n);
        if (n == 0) return 0;
        uint64_t sign = 1ull << (n - 1);
        return (raw & sign) ? (int64_t)(raw | ~((sign << 1) - 1))
                            : (int64_t)raw;
    }

    uint32_t read_unary() {
        uint32_t count = 0;
        while (true) {
            if (pos >= size) { error = true; return 0; }
            if (read_bits(1)) return count;
            ++count;
            if (error) return 0;
        }
    }

    void align() { if (bit) { bit = 0; ++pos; } }
};

// UTF-8-style coded number used for frame/sample indices
uint64_t read_utf8(BitReader& br) {
    uint64_t first = br.read_bits(8);
    if (first < 0x80) return first;
    int extra = 0;
    uint64_t mask = 0x40;
    while (first & mask) { ++extra; mask >>= 1; }
    uint64_t value = first & (mask - 1);
    for (int i = 0; i < extra; ++i)
        value = (value << 6) | (br.read_bits(8) & 0x3F);
    return value;
}

bool decode_residual(BitReader& br, int predictor_order,
                     int block_size, int64_t* out) {
    int method = (int)br.read_bits(2);
    if (method > 1) return false;
    int param_bits = method == 0 ? 4 : 5;
    int escape = method == 0 ? 0xF : 0x1F;

    int partition_order = (int)br.read_bits(4);
    int partitions = 1 << partition_order;
    if (block_size % partitions) return false;
    int samples_per = block_size >> partition_order;

    int idx = predictor_order;
    for (int p = 0; p < partitions; ++p) {
        int count = samples_per - (p == 0 ? predictor_order : 0);
        if (count < 0) return false;
        int param = (int)br.read_bits(param_bits);
        if (param == escape) {
            int raw_bits = (int)br.read_bits(5);
            for (int i = 0; i < count; ++i)
                out[idx++] = raw_bits ? br.read_signed(raw_bits) : 0;
        } else {
            for (int i = 0; i < count; ++i) {
                uint64_t quotient = br.read_unary();
                uint64_t remainder = param ? br.read_bits(param) : 0;
                uint64_t zigzag = (quotient << param) | remainder;
                out[idx++] = (int64_t)(zigzag >> 1)
                    ^ -(int64_t)(zigzag & 1);
            }
        }
        if (br.error) return false;
    }
    return true;
}

bool decode_subframe(BitReader& br, int block_size, int bps,
                     int64_t* out) {
    if (br.read_bits(1)) return false;  // padding bit must be 0
    int type = (int)br.read_bits(6);
    int wasted = 0;
    if (br.read_bits(1)) wasted = (int)br.read_unary() + 1;
    bps -= wasted;
    if (bps <= 0 || bps > 33) return false;

    if (type == 0) {                       // CONSTANT
        int64_t value = br.read_signed(bps);
        for (int i = 0; i < block_size; ++i) out[i] = value;
    } else if (type == 1) {                // VERBATIM
        for (int i = 0; i < block_size; ++i)
            out[i] = br.read_signed(bps);
    } else if ((type & 0x38) == 0x08) {    // FIXED, order 0..4
        int order = type & 0x07;
        if (order > 4 || order > block_size) return false;
        for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
        if (!decode_residual(br, order, block_size, out)) return false;
        for (int i = order; i < block_size; ++i) {
            int64_t p = 0;
            switch (order) {
                case 0: p = 0; break;
                case 1: p = out[i - 1]; break;
                case 2: p = 2 * out[i - 1] - out[i - 2]; break;
                case 3: p = 3 * out[i - 1] - 3 * out[i - 2]
                            + out[i - 3]; break;
                case 4: p = 4 * out[i - 1] - 6 * out[i - 2]
                            + 4 * out[i - 3] - out[i - 4]; break;
            }
            out[i] += p;
        }
    } else if (type & 0x20) {              // LPC
        int order = (type & 0x1F) + 1;
        if (order > block_size) return false;
        for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
        int precision = (int)br.read_bits(4) + 1;
        if (precision == 16) return false;  // invalid code 1111
        int shift = (int)br.read_signed(5);
        if (shift < 0) return false;
        int64_t coefs[32];
        for (int i = 0; i < order; ++i)
            coefs[i] = br.read_signed(precision);
        if (!decode_residual(br, order, block_size, out)) return false;
        for (int i = order; i < block_size; ++i) {
            int64_t acc = 0;
            for (int j = 0; j < order; ++j)
                acc += coefs[j] * out[i - 1 - j];
            out[i] += acc >> shift;
        }
    } else {
        return false;
    }

    if (wasted)
        for (int i = 0; i < block_size; ++i) out[i] <<= wasted;
    return !br.error;
}

struct StreamInfo {
    uint32_t sample_rate = 0;
    int channels = 0;
    int bits = 0;
    uint64_t total_samples = 0;
    size_t frames_offset = 0;  // first audio frame byte offset
};

bool parse_header(const uint8_t* data, size_t size, StreamInfo* info) {
    if (size < 42 || memcmp(data, "fLaC", 4)) return false;
    size_t pos = 4;
    bool last = false;
    bool seen_streaminfo = false;
    while (!last) {
        if (pos + 4 > size) return false;
        last = data[pos] & 0x80;
        int type = data[pos] & 0x7F;
        uint32_t length = (data[pos + 1] << 16) | (data[pos + 2] << 8)
            | data[pos + 3];
        pos += 4;
        if (pos + length > size) return false;
        if (type == 0 && length >= 34) {
            const uint8_t* b = data + pos;
            info->sample_rate =
                ((uint32_t)b[10] << 12) | ((uint32_t)b[11] << 4)
                | (b[12] >> 4);
            info->channels = ((b[12] >> 1) & 0x7) + 1;
            info->bits = (((b[12] & 1) << 4) | (b[13] >> 4)) + 1;
            info->total_samples =
                ((uint64_t)(b[13] & 0x0F) << 32)
                | ((uint64_t)b[14] << 24) | ((uint64_t)b[15] << 16)
                | ((uint64_t)b[16] << 8) | b[17];
            seen_streaminfo = true;
        }
        pos += length;
    }
    info->frames_offset = pos;
    return seen_streaminfo && info->sample_rate && info->channels;
}

const int kBlockSizes[16] = {
    0, 192, 576, 1152, 2304, 4608, -1, -2,  // -1/-2: coded in header
    256, 512, 1024, 2048, 4096, 8192, 16384, 32768};

std::vector<uint8_t> read_file(const char* path) {
    std::vector<uint8_t> buffer;
    FILE* fp = fopen(path, "rb");
    if (!fp) return buffer;
    fseek(fp, 0, SEEK_END);
    long size = ftell(fp);
    fseek(fp, 0, SEEK_SET);
    buffer.resize(size);
    if (fread(buffer.data(), 1, size, fp) != (size_t)size)
        buffer.clear();
    fclose(fp);
    return buffer;
}

}  // namespace

extern "C" {

// STREAMINFO scan: fills channels/rate/bits/total samples; 0 on success.
int shennong_flac_scan(const char* path, int32_t* channels,
                       int32_t* sample_rate, int32_t* bits,
                       int64_t* nsamples) {
    std::vector<uint8_t> file = read_file(path);
    if (file.empty()) return 1;
    StreamInfo info;
    if (!parse_header(file.data(), file.size(), &info)) return 2;
    *channels = info.channels;
    *sample_rate = info.sample_rate;
    *bits = info.bits;
    *nsamples = (int64_t)info.total_samples;
    return 0;
}

// Full decode into a caller-allocated interleaved int32 buffer of
// capacity samples*channels. Returns decoded frame count (per
// channel), or a negative error code.
int64_t shennong_flac_decode(const char* path, int32_t* out,
                             int64_t capacity) {
    std::vector<uint8_t> file = read_file(path);
    if (file.empty()) return -1;
    StreamInfo info;
    if (!parse_header(file.data(), file.size(), &info)) return -2;

    BitReader br{file.data(), file.size()};
    br.pos = info.frames_offset;

    std::vector<std::vector<int64_t>> channels(info.channels);
    int64_t decoded = 0;

    while (br.pos < br.size && !br.error) {
        // frame sync: 14 bits 0b11111111111110
        uint64_t sync = br.read_bits(14);
        if (br.error) break;  // clean EOF
        if (sync != 0x3FFE) return -3;
        br.read_bits(1);                       // reserved
        br.read_bits(1);                       // blocking strategy
        int bs_code = (int)br.read_bits(4);
        int sr_code = (int)br.read_bits(4);
        int ch_code = (int)br.read_bits(4);
        int ss_code = (int)br.read_bits(3);
        br.read_bits(1);                       // reserved
        read_utf8(br);                         // frame/sample number

        int block_size = kBlockSizes[bs_code];
        if (block_size == 0) return -4;
        if (block_size == -1) block_size = (int)br.read_bits(8) + 1;
        else if (block_size == -2) block_size = (int)br.read_bits(16) + 1;

        if (sr_code == 12) br.read_bits(8);
        else if (sr_code == 13 || sr_code == 14) br.read_bits(16);

        static const int kBits[8] = {0, 8, 12, 0, 16, 20, 24, 32};
        int bps = ss_code ? kBits[ss_code] : info.bits;
        if (!bps) return -5;

        br.read_bits(8);                       // header CRC-8

        int nch = ch_code < 8 ? ch_code + 1 : 2;
        if (nch != info.channels) return -6;
        for (auto& ch : channels) ch.resize(block_size);

        for (int c = 0; c < nch; ++c) {
            int sub_bps = bps;
            // the side channel carries one extra bit
            if ((ch_code == 8 && c == 1) || (ch_code == 9 && c == 0)
                || (ch_code == 10 && c == 1))
                ++sub_bps;
            if (!decode_subframe(br, block_size, sub_bps,
                                 channels[c].data()))
                return -7;
        }
        br.align();
        br.read_bits(16);                      // frame CRC-16

        // stereo decorrelation
        if (ch_code == 8) {                    // left/side
            for (int i = 0; i < block_size; ++i)
                channels[1][i] = channels[0][i] - channels[1][i];
        } else if (ch_code == 9) {             // right/side
            for (int i = 0; i < block_size; ++i)
                channels[0][i] = channels[0][i] + channels[1][i];
        } else if (ch_code == 10) {            // mid/side
            for (int i = 0; i < block_size; ++i) {
                int64_t side = channels[1][i];
                int64_t mid = (channels[0][i] << 1) | (side & 1);
                channels[0][i] = (mid + side) >> 1;
                channels[1][i] = (mid - side) >> 1;
            }
        }

        if ((decoded + block_size) * info.channels > capacity)
            return -8;
        for (int i = 0; i < block_size; ++i)
            for (int c = 0; c < info.channels; ++c)
                out[(decoded + i) * info.channels + c] =
                    (int32_t)channels[c][i];
        decoded += block_size;

        if (info.total_samples && decoded >= (int64_t)info.total_samples)
            break;
    }
    return decoded;
}

}  // extern "C"

// FLAC stream decoder (C ABI, ctypes-loaded).
//
// The host data pipeline's own FLAC decoder, in place of the reference's
// libsndfile path (AudioSegment.from_file -> soundfile.read): LibriSpeech
// and most ASR corpora ship FLAC, and no system FLAC library is assumed.
// Built at first use by conformer_nemo_tpu_torch/ops/build.py (g++). Implements the full FLAC subset that encoders
// emit for speech corpora: CONSTANT / VERBATIM / FIXED(0-4) / LPC(1-32)
// subframes, rice partitions (4- and 5-bit params + escape codes), wasted
// bits, all four channel assignments (independent, left/side, right/side,
// mid/side), 8..24-bit samples. CRCs are consumed but not verified (inputs
// are trusted local files).
//
// spec: https://xiph.org/flac/format.html

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

struct BitReader {
    const uint8_t* data;
    size_t size;
    size_t byte_pos = 0;
    int bit_pos = 0;  // bits consumed of current byte (0..7)
    bool error = false;

    bool at_end() const { return byte_pos >= size; }

    uint32_t read_bit() {
        if (byte_pos >= size) { error = true; return 0; }
        uint32_t b = (data[byte_pos] >> (7 - bit_pos)) & 1u;
        if (++bit_pos == 8) { bit_pos = 0; ++byte_pos; }
        return b;
    }

    uint64_t read_bits(int n) {  // n <= 57
        uint64_t v = 0;
        while (n > 0) {
            if (byte_pos >= size) { error = true; return 0; }
            int avail = 8 - bit_pos;
            int take = n < avail ? n : avail;
            uint32_t cur = data[byte_pos];
            uint32_t chunk = (cur >> (avail - take)) & ((1u << take) - 1u);
            v = (v << take) | chunk;
            bit_pos += take;
            if (bit_pos == 8) { bit_pos = 0; ++byte_pos; }
            n -= take;
        }
        return v;
    }

    int64_t read_signed(int n) {
        if (n == 0) return 0;
        uint64_t v = read_bits(n);
        uint64_t sign = 1ull << (n - 1);
        return (v & sign) ? (int64_t)(v | ~((sign << 1) - 1)) : (int64_t)v;
    }

    uint32_t read_unary() {
        uint32_t q = 0;
        while (!error && read_bit() == 0) {
            ++q;
            if (q > (1u << 24)) { error = true; break; }  // corrupt stream guard
        }
        return q;
    }

    void align_byte() {
        if (bit_pos) { bit_pos = 0; ++byte_pos; }
    }
};

// UTF-8-style coded number in frame headers (up to 56 bits); value discarded.
void skip_utf8_number(BitReader& br) {
    uint32_t first = (uint32_t)br.read_bits(8);
    int follow = 0;
    for (uint32_t m = 0x80; first & m; m >>= 1) ++follow;
    if (follow > 0) --follow;  // first 1-bit run of length k => k-1 follow bytes
    for (int i = 0; i < follow; ++i) br.read_bits(8);
}

bool decode_residual(BitReader& br, int32_t* out, int block_size, int order) {
    int method = (int)br.read_bits(2);
    if (method > 1) return false;
    int plen = method == 0 ? 4 : 5;
    uint32_t escape = method == 0 ? 15 : 31;
    int po = (int)br.read_bits(4);
    int partitions = 1 << po;
    int psize = block_size >> po;
    if (psize <= 0 || (block_size % partitions) != 0) return false;
    int idx = order;
    for (int p = 0; p < partitions; ++p) {
        int count = psize - (p == 0 ? order : 0);
        if (count < 0) return false;
        uint32_t param = (uint32_t)br.read_bits(plen);
        if (param == escape) {
            int raw = (int)br.read_bits(5);
            for (int i = 0; i < count; ++i) out[idx++] = (int32_t)br.read_signed(raw);
        } else {
            for (int i = 0; i < count; ++i) {
                uint32_t q = br.read_unary();
                uint64_t u = ((uint64_t)q << param) | br.read_bits((int)param);
                out[idx++] = (int32_t)((u >> 1) ^ (~(u & 1) + 1));  // zigzag
            }
        }
        if (br.error) return false;
    }
    return idx == block_size;
}

bool decode_subframe(BitReader& br, int32_t* out, int block_size, int bps) {
    if (br.read_bit() != 0) return false;  // mandatory zero pad bit
    int type = (int)br.read_bits(6);
    int wasted = 0;
    if (br.read_bit()) {
        wasted = 1 + (int)br.read_unary();
        bps -= wasted;
    }
    if (bps <= 0 || bps > 33) return false;

    if (type == 0) {  // CONSTANT
        int64_t v = br.read_signed(bps);
        for (int i = 0; i < block_size; ++i) out[i] = (int32_t)v;
    } else if (type == 1) {  // VERBATIM
        for (int i = 0; i < block_size; ++i) out[i] = (int32_t)br.read_signed(bps);
    } else if (type >= 8 && type <= 12) {  // FIXED, order 0-4
        int order = type - 8;
        if (order > block_size) return false;
        for (int i = 0; i < order; ++i) out[i] = (int32_t)br.read_signed(bps);
        if (!decode_residual(br, out, block_size, order)) return false;
        switch (order) {
            case 0: break;
            case 1:
                for (int i = 1; i < block_size; ++i) out[i] += out[i - 1];
                break;
            case 2:
                for (int i = 2; i < block_size; ++i)
                    out[i] += 2 * out[i - 1] - out[i - 2];
                break;
            case 3:
                for (int i = 3; i < block_size; ++i)
                    out[i] += 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3];
                break;
            case 4:
                for (int i = 4; i < block_size; ++i)
                    out[i] += 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3] - out[i - 4];
                break;
        }
    } else if (type >= 32) {  // LPC, order 1-32
        int order = (type & 31) + 1;
        if (order > block_size) return false;
        for (int i = 0; i < order; ++i) out[i] = (int32_t)br.read_signed(bps);
        int precision = (int)br.read_bits(4) + 1;
        if (precision == 16) return false;  // 0b1111 is invalid
        int shift = (int)br.read_signed(5);
        if (shift < 0) return false;
        int64_t coef[32];
        for (int i = 0; i < order; ++i) coef[i] = br.read_signed(precision);
        if (!decode_residual(br, out, block_size, order)) return false;
        for (int i = order; i < block_size; ++i) {
            int64_t acc = 0;
            for (int j = 0; j < order; ++j) acc += coef[j] * (int64_t)out[i - 1 - j];
            out[i] += (int32_t)(acc >> shift);
        }
    } else {
        return false;  // reserved type
    }
    if (wasted)
        for (int i = 0; i < block_size; ++i) out[i] = (int32_t)((uint32_t)out[i] << wasted);
    return !br.error;
}

}  // namespace

extern "C" {

// Decodes a whole FLAC stream held in memory.
// Returns 0 on success; fills *out (malloc'd, interleaved int32 in the file's
// bit depth), *out_samples (per channel), *channels, *sample_rate, *bps.
// Caller frees with flac_free. Negative return = error code.
int flac_decode(const uint8_t* data, int64_t size, int32_t** out,
                int64_t* out_samples, int* channels, int* sample_rate, int* bps) {
    if (size < 42 || memcmp(data, "fLaC", 4) != 0) return -1;
    size_t pos = 4;
    int sr = 0, nch = 0, bits = 0;
    uint64_t total = 0;
    bool have_streaminfo = false;
    // metadata blocks
    while (pos + 4 <= (size_t)size) {
        uint8_t hdr = data[pos];
        uint32_t len = ((uint32_t)data[pos + 1] << 16) | ((uint32_t)data[pos + 2] << 8)
                       | data[pos + 3];
        pos += 4;
        if ((hdr & 0x7f) == 0 && len >= 34) {  // STREAMINFO
            const uint8_t* s = data + pos;
            sr = ((int)s[10] << 12) | ((int)s[11] << 4) | (s[12] >> 4);
            nch = ((s[12] >> 1) & 0x7) + 1;
            bits = (((s[12] & 1) << 4) | (s[13] >> 4)) + 1;
            total = ((uint64_t)(s[13] & 0x0f) << 32) | ((uint64_t)s[14] << 24)
                    | ((uint64_t)s[15] << 16) | ((uint64_t)s[16] << 8) | s[17];
            have_streaminfo = true;
        }
        pos += len;
        if (hdr & 0x80) break;  // last metadata block
    }
    if (!have_streaminfo || sr <= 0 || nch <= 0 || nch > 8 || bits <= 0 || bits > 32)
        return -2;

    // output buffer: grow if total-samples field is 0 (unknown)
    uint64_t cap = total ? total : 65536;
    int32_t* buf = (int32_t*)malloc(cap * nch * sizeof(int32_t));
    if (!buf) return -3;
    uint64_t written = 0;

    static const int kBlock1[16] = {0, 192, 576, 1152, 2304, 4608, -1, -2,
                                    256, 512, 1024, 2048, 4096, 8192, 16384, 32768};

    BitReader br{data, (size_t)size};
    br.byte_pos = pos;

    int32_t* ch_buf[8] = {nullptr};
    int ch_cap = 0;

    while (br.byte_pos < br.size && !br.error) {
        // frame sync 11111111 111110xx
        uint32_t sync = (uint32_t)br.read_bits(14);
        if (br.error || br.at_end()) break;
        if (sync != 0x3ffe) { free(buf); for (auto* c : ch_buf) free(c); return -4; }
        br.read_bit();                      // reserved
        br.read_bit();                      // blocking strategy
        int bs_code = (int)br.read_bits(4);
        int sr_code = (int)br.read_bits(4);
        int ch_code = (int)br.read_bits(4);
        int ss_code = (int)br.read_bits(3);
        br.read_bit();  // reserved
        skip_utf8_number(br);
        int block_size;
        if (bs_code == 6) block_size = (int)br.read_bits(8) + 1;
        else if (bs_code == 7) block_size = (int)br.read_bits(16) + 1;
        else if (bs_code == 0) { free(buf); for (auto* c : ch_buf) free(c); return -5; }
        else block_size = kBlock1[bs_code];
        if (sr_code == 12) br.read_bits(8);
        else if (sr_code == 13 || sr_code == 14) br.read_bits(16);
        static const int kBits[8] = {0, 8, 12, 0, 16, 20, 24, 32};
        int fbits = ss_code == 0 ? bits : kBits[ss_code];
        if (fbits == 0) { free(buf); for (auto* c : ch_buf) free(c); return -6; }
        br.read_bits(8);  // header CRC-8 (consumed, not verified)

        int fch = ch_code < 8 ? ch_code + 1 : 2;
        if (fch != nch || block_size <= 0) {
            free(buf); for (auto* c : ch_buf) free(c); return -7;
        }
        if (block_size > ch_cap) {
            for (int c = 0; c < nch; ++c) {
                free(ch_buf[c]);
                ch_buf[c] = (int32_t*)malloc(block_size * sizeof(int32_t));
                if (!ch_buf[c]) { free(buf); return -3; }
            }
            ch_cap = block_size;
        }

        for (int c = 0; c < nch; ++c) {
            int sub_bps = fbits;
            // the side channel carries one extra bit
            if ((ch_code == 8 && c == 1) || (ch_code == 9 && c == 0) ||
                (ch_code == 10 && c == 1))
                sub_bps += 1;
            if (!decode_subframe(br, ch_buf[c], block_size, sub_bps)) {
                free(buf); for (auto* cb : ch_buf) free(cb); return -8;
            }
        }
        br.align_byte();
        br.read_bits(16);  // frame CRC-16 (consumed, not verified)

        // stereo decorrelation
        if (ch_code == 8) {          // left/side
            for (int i = 0; i < block_size; ++i)
                ch_buf[1][i] = ch_buf[0][i] - ch_buf[1][i];
        } else if (ch_code == 9) {   // right/side: left = side + right
            for (int i = 0; i < block_size; ++i)
                ch_buf[0][i] = ch_buf[0][i] + ch_buf[1][i];
        } else if (ch_code == 10) {  // mid/side
            for (int i = 0; i < block_size; ++i) {
                int64_t side = ch_buf[1][i];
                int64_t mid = ((int64_t)ch_buf[0][i] << 1) | (side & 1);
                ch_buf[0][i] = (int32_t)((mid + side) >> 1);
                ch_buf[1][i] = (int32_t)((mid - side) >> 1);
            }
        }

        if (written + (uint64_t)block_size > cap) {
            uint64_t ncap = cap * 2 + block_size;
            int32_t* nb = (int32_t*)realloc(buf, ncap * nch * sizeof(int32_t));
            if (!nb) { free(buf); for (auto* c : ch_buf) free(c); return -3; }
            buf = nb;
            cap = ncap;
        }
        for (int i = 0; i < block_size; ++i)
            for (int c = 0; c < nch; ++c)
                buf[(written + i) * nch + c] = ch_buf[c][i];
        written += block_size;
        if (total && written >= total) break;
    }
    for (auto* c : ch_buf) free(c);
    if (total && written > total) written = total;
    *out = buf;
    *out_samples = (int64_t)written;
    *channels = nch;
    *sample_rate = sr;
    *bps = bits;
    return 0;
}

void flac_free(int32_t* p) { free(p); }

}  // extern "C"

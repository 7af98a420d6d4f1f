// encodermap_tpu_torch/data/native/xdr_xtc.cpp
//
// Native GROMACS XTC trajectory decoder.
//
// The reference reaches compressed-trajectory IO through mdtraj's C
// extensions; mdtraj is not available in this environment, so this is a
// from-scratch implementation of the public XTC container format
// (XDR big-endian framing + the 3dfcoord fixed-point delta compression
// scheme described in the GROMACS manual / xdrfile documentation).
//
// Exposed C ABI (ctypes-friendly):
//   xtc_scan(path, &n_frames, &n_atoms, offsets_buf, max_offsets)
//       -> scan frame byte offsets without decompressing
//   xtc_read_frames(path, offsets, n, n_atoms, xyz, box, time, step)
//       -> decode selected frames into caller-provided buffers
//
// Build: g++ -O3 -shared -fPIC xdr_xtc.cpp -o libxdrxtc.so

#include <cstdint>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <vector>

namespace {

// ---------------------------------------------------------------- XDR input
struct XdrFile {
    FILE* fp = nullptr;
    bool ok = true;

    explicit XdrFile(const char* path) { fp = std::fopen(path, "rb"); ok = fp != nullptr; }
    ~XdrFile() { if (fp) std::fclose(fp); }

    bool read_raw(void* dst, size_t n) {
        if (!ok) return false;
        ok = std::fread(dst, 1, n, fp) == n;
        return ok;
    }
    int32_t read_int() {
        unsigned char b[4] = {0, 0, 0, 0};
        read_raw(b, 4);
        return (int32_t)(((uint32_t)b[0] << 24) | ((uint32_t)b[1] << 16) |
                         ((uint32_t)b[2] << 8) | (uint32_t)b[3]);
    }
    float read_float() {
        uint32_t u;
        unsigned char b[4] = {0, 0, 0, 0};
        read_raw(b, 4);
        u = ((uint32_t)b[0] << 24) | ((uint32_t)b[1] << 16) |
            ((uint32_t)b[2] << 8) | (uint32_t)b[3];
        float f;
        std::memcpy(&f, &u, 4);
        return f;
    }
    bool skip(long n) {
        if (!ok) return false;
        ok = std::fseek(fp, n, SEEK_CUR) == 0;
        return ok;
    }
    bool seek(int64_t pos) {
        if (!fp) return false;
        ok = std::fseek(fp, (long)pos, SEEK_SET) == 0;
        return ok;
    }
    int64_t tell() { return fp ? std::ftell(fp) : -1; }
    bool eof() { return fp ? std::feof(fp) != 0 : true; }
};

// ------------------------------------------------------- bit-stream reading
struct BitReader {
    const unsigned char* data;
    size_t size;
    size_t byte = 0;
    int bit = 0;  // bits consumed in current byte (0..7)

    uint32_t read_bits(int nbits) {
        uint32_t value = 0;
        for (int i = 0; i < nbits; ++i) {
            uint32_t b = 0;
            if (byte < size) b = (data[byte] >> (7 - bit)) & 1u;
            value = (value << 1) | b;
            if (++bit == 8) { bit = 0; ++byte; }
        }
        return value;
    }
};

const int MAGICINTS[] = {
    0,        0,        0,       0,       0,       0,       0,       0,
    0,        8,        10,      12,      16,      20,      25,      32,
    40,       50,       64,      80,      101,     128,     161,     203,
    256,      322,      406,     512,     645,     812,     1024,    1290,
    1625,     2048,     2580,    3250,    4096,    5060,    6501,    8192,
    10321,    13003,    16384,   20642,   26007,   32768,   41285,   52015,
    65536,    82570,    104031,  131072,  165140,  208063,  262144,  330280,
    416127,   524287,   660561,  832255,  1048576, 1321122, 1664510, 2097152,
    2642245,  3329021,  4194304, 5284491, 6658042, 8388607, 10568983,
    13316085, 16777216};
const int FIRSTIDX = 9;
const int LASTIDX = (int)(sizeof(MAGICINTS) / sizeof(int)) - 1;

int sizeofint(int size) {
    int num = 1, nbits = 0;
    while (size >= num && nbits < 32) { ++nbits; num <<= 1; }
    return nbits;
}

// bits needed for num_of_ints values with the given ranges, encoded as one
// mixed-radix integer (byte-array big-number arithmetic).
int sizeofints(int num_of_ints, const unsigned int sizes[]) {
    unsigned int bytes[32];
    int num_of_bytes = 1;
    bytes[0] = 1;
    unsigned int num_of_bits = 0;
    for (int i = 0; i < num_of_ints; ++i) {
        unsigned int tmp = 0;
        int bytecnt;
        for (bytecnt = 0; bytecnt < num_of_bytes; ++bytecnt) {
            tmp += bytes[bytecnt] * sizes[i];
            bytes[bytecnt] = tmp & 0xff;
            tmp >>= 8;
        }
        while (tmp != 0) {
            bytes[bytecnt++] = tmp & 0xff;
            tmp >>= 8;
        }
        num_of_bytes = bytecnt;
    }
    int num = 1;
    --num_of_bytes;
    while ((int)bytes[num_of_bytes] >= num) {
        ++num_of_bits;
        num *= 2;
    }
    return (int)num_of_bits + num_of_bytes * 8;
}

// Decode num_of_ints values packed as a mixed-radix big number in num_of_bits
// bits (little-endian byte significance, as the xdrfile format specifies).
void decodeints(BitReader& br, int num_of_ints, int num_of_bits,
                const unsigned int sizes[], int nums[]) {
    int bytes[32];
    bytes[0] = bytes[1] = bytes[2] = bytes[3] = 0;
    int num_of_bytes = 0;
    while (num_of_bits > 8) {
        // NOTE: the format stores bytes most-significant-bit-first within
        // the stream, but byte significance is little-endian.
        bytes[num_of_bytes++] = (int)br.read_bits(8);
        num_of_bits -= 8;
    }
    if (num_of_bits > 0) bytes[num_of_bytes++] = (int)br.read_bits(num_of_bits);
    for (int i = num_of_ints - 1; i > 0; --i) {
        // unsigned arithmetic, as in the reference xdrfile: with signed
        // ints, (num << 8) overflows for sizes > 2^23 (remainder can
        // reach sizes[i]-1 ~ 2^24) and signed division then decodes
        // garbage coordinates silently
        unsigned int num = 0;
        for (int j = num_of_bytes - 1; j >= 0; --j) {
            num = (num << 8) | (unsigned int)bytes[j];
            unsigned int p = num / sizes[i];
            bytes[j] = (int)p;
            num = num - p * sizes[i];
        }
        nums[i] = (int)num;
    }
    nums[0] = bytes[0] | (bytes[1] << 8) | (bytes[2] << 16) | (bytes[3] << 24);
}

// Decompress one frame's coordinates (after the 9-float box has been read).
// Returns number of atoms, or -1 on failure.
int decompress_coords(XdrFile& xf, float* out /* n_atoms*3 */, int n_atoms_expected) {
    int lsize = xf.read_int();
    if (!xf.ok || lsize <= 0) return -1;
    if (n_atoms_expected > 0 && lsize != n_atoms_expected) return -1;

    if (lsize <= 9) {  // small systems are stored as plain floats
        for (int i = 0; i < lsize * 3; ++i) out[i] = xf.read_float();
        return xf.ok ? lsize : -1;
    }

    float precision = xf.read_float();
    if (precision <= 0) precision = 1000.0f;
    float inv_precision = 1.0f / precision;

    int minint[3], maxint[3];
    for (int i = 0; i < 3; ++i) minint[i] = xf.read_int();
    for (int i = 0; i < 3; ++i) maxint[i] = xf.read_int();
    // corrupt headers with maxint < minint would make sizeint 0 (or
    // wrap) and crash decodeints with a hardware divide-by-zero; the
    // span must be computed in 64-bit — maxint-minint on int32 is UB for
    // spans >= 2^31, and a full 2^32 span wraps sizeint to 0 even when
    // maxint >= minint
    for (int i = 0; i < 3; ++i)
        if (maxint[i] < minint[i]) return -1;

    unsigned int sizeint[3], sizesmall[3], bitsizeint[3] = {0, 0, 0};
    for (int i = 0; i < 3; ++i) {
        int64_t span = (int64_t)maxint[i] - (int64_t)minint[i] + 1;
        if (span <= 0 || span > 0xffffffffLL) return -1;
        sizeint[i] = (unsigned int)span;
        if (sizeint[i] == 0) return -1;
    }

    int bitsize;
    if ((sizeint[0] | sizeint[1] | sizeint[2]) > 0xffffff) {
        bitsizeint[0] = sizeofint((int)sizeint[0]);
        bitsizeint[1] = sizeofint((int)sizeint[1]);
        bitsizeint[2] = sizeofint((int)sizeint[2]);
        bitsize = 0;
    } else {
        bitsize = sizeofints(3, sizeint);
    }

    int smallidx = xf.read_int();
    if (!xf.ok || smallidx < FIRSTIDX || smallidx > LASTIDX) {
        if (smallidx < FIRSTIDX) smallidx = FIRSTIDX;
        if (smallidx > LASTIDX) return -1;
    }
    int smaller = MAGICINTS[smallidx > FIRSTIDX ? smallidx - 1 : FIRSTIDX] / 2;
    int smallnum = MAGICINTS[smallidx] / 2;
    sizesmall[0] = sizesmall[1] = sizesmall[2] = (unsigned int)MAGICINTS[smallidx];

    int nbytes = xf.read_int();
    if (!xf.ok || nbytes <= 0 || nbytes > (1 << 28)) return -1;
    std::vector<unsigned char> packed((size_t)((nbytes + 3) / 4) * 4);
    if (!xf.read_raw(packed.data(), packed.size())) return -1;

    BitReader br{packed.data(), packed.size()};

    int thiscoord[3], prevcoord[3] = {0, 0, 0};
    float* lfp = out;
    int i = 0, run = 0;
    while (i < lsize) {
        if (bitsize == 0) {
            thiscoord[0] = (int)br.read_bits((int)bitsizeint[0]);
            thiscoord[1] = (int)br.read_bits((int)bitsizeint[1]);
            thiscoord[2] = (int)br.read_bits((int)bitsizeint[2]);
        } else {
            decodeints(br, 3, bitsize, sizeint, thiscoord);
        }
        ++i;
        thiscoord[0] += minint[0];
        thiscoord[1] += minint[1];
        thiscoord[2] += minint[2];
        prevcoord[0] = thiscoord[0];
        prevcoord[1] = thiscoord[1];
        prevcoord[2] = thiscoord[2];

        // The run length persists across atoms: the encoder emits flag=1 and
        // a new 5-bit (run + is_smaller + 1) only when the run length
        // CHANGES; flag=0 means "same run length as before".
        int flag = (int)br.read_bits(1);
        int is_smaller = 0;
        if (flag == 1) {
            run = (int)br.read_bits(5);
            is_smaller = run % 3;
            run -= is_smaller;
            --is_smaller;
        }
        if (run > 0) {
            for (int k = 0; k < run; k += 3) {
                // a corrupt run length must not write past the caller's
                // exact-size (lsize * 3) output buffer
                if (i >= lsize) return -1;
                decodeints(br, 3, smallidx, sizesmall, thiscoord);
                ++i;
                thiscoord[0] += prevcoord[0] - smallnum;
                thiscoord[1] += prevcoord[1] - smallnum;
                thiscoord[2] += prevcoord[2] - smallnum;
                if (k == 0) {
                    // water-molecule trick: the first delta-atom is written
                    // BEFORE the anchor atom (swap improves compression).
                    int tmp;
                    tmp = thiscoord[0]; thiscoord[0] = prevcoord[0]; prevcoord[0] = tmp;
                    tmp = thiscoord[1]; thiscoord[1] = prevcoord[1]; prevcoord[1] = tmp;
                    tmp = thiscoord[2]; thiscoord[2] = prevcoord[2]; prevcoord[2] = tmp;
                    *lfp++ = (float)prevcoord[0] * inv_precision;
                    *lfp++ = (float)prevcoord[1] * inv_precision;
                    *lfp++ = (float)prevcoord[2] * inv_precision;
                } else {
                    prevcoord[0] = thiscoord[0];
                    prevcoord[1] = thiscoord[1];
                    prevcoord[2] = thiscoord[2];
                }
                *lfp++ = (float)thiscoord[0] * inv_precision;
                *lfp++ = (float)thiscoord[1] * inv_precision;
                *lfp++ = (float)thiscoord[2] * inv_precision;
            }
        } else {
            *lfp++ = (float)thiscoord[0] * inv_precision;
            *lfp++ = (float)thiscoord[1] * inv_precision;
            *lfp++ = (float)thiscoord[2] * inv_precision;
        }
        smallidx += is_smaller;
        // corrupt streams can push smallidx past the MAGICINTS table one
        // +1 at a time: unchecked, that is an out-of-bounds read here and
        // eventually a stack overflow in decodeints (bytes[32])
        if (smallidx < FIRSTIDX || smallidx > LASTIDX) return -1;
        if (is_smaller < 0) {
            smallnum = smaller;
            if (smallidx > FIRSTIDX) smaller = MAGICINTS[smallidx - 1] / 2;
            else smaller = 0;
        } else if (is_smaller > 0) {
            smaller = smallnum;
            smallnum = MAGICINTS[smallidx] / 2;
        }
        sizesmall[0] = sizesmall[1] = sizesmall[2] = (unsigned int)MAGICINTS[smallidx];
        if (sizesmall[0] == 0) return -1;
    }
    return lsize;
}

const int32_t XTC_MAGIC = 1995;

// Skip the coordinate payload of the current frame (header already read).
bool skip_coords(XdrFile& xf, int natoms) {
    int lsize = xf.read_int();
    if (!xf.ok || lsize != natoms) return false;
    if (lsize <= 9) return xf.skip((long)lsize * 3 * 4);
    if (!xf.skip(4 + 6 * 4 + 4)) return false;  // precision, min/max ints, smallidx
    int nbytes = xf.read_int();
    if (!xf.ok || nbytes < 0) return false;
    return xf.skip(((long)nbytes + 3) / 4 * 4);
}

}  // namespace

extern "C" {

// Scan the file: frame count, atom count, per-frame byte offsets.
// Returns 0 on success.
int xtc_scan(const char* path, int64_t* n_frames, int32_t* n_atoms,
             int64_t* offsets, int64_t max_offsets) {
    XdrFile xf(path);
    if (!xf.ok) return 1;
    // file size: skip_coords fseeks, which succeeds PAST EOF — a frame
    // whose payload extends beyond the file (truncated copy / live
    // simulation) must not be counted, or a later whole-file read fails
    std::fseek(xf.fp, 0, SEEK_END);
    int64_t file_size = xf.tell();
    std::fseek(xf.fp, 0, SEEK_SET);
    int64_t count = 0;
    int32_t natoms = -1;
    for (;;) {
        int64_t pos = xf.tell();
        int32_t magic = xf.read_int();
        if (!xf.ok) break;  // clean EOF
        if (magic != XTC_MAGIC) return 2;
        int32_t na = xf.read_int();
        if (natoms < 0) natoms = na;
        else if (na != natoms) return 3;
        xf.read_int();    // step
        xf.read_float();  // time
        if (!xf.skip(9 * 4)) return 4;  // box
        if (!skip_coords(xf, natoms)) {
            if (xf.eof()) break;  // truncated final frame
            return 5;             // mid-file corruption stays an error
        }
        if (xf.tell() > file_size) break;  // payload past EOF
        if (offsets && count < max_offsets) offsets[count] = pos;
        ++count;
    }
    *n_frames = count;
    *n_atoms = natoms;
    return 0;
}

// Read n frames at the given byte offsets. Buffers:
//   xyz:  n * n_atoms * 3 floats
//   box:  n * 9 floats  (row-major 3x3, nm)
//   time: n floats
//   step: n int32
// Returns 0 on success.
int xtc_read_frames(const char* path, const int64_t* offsets, int64_t n,
                    int32_t n_atoms, float* xyz, float* box, float* time,
                    int32_t* step) {
    XdrFile xf(path);
    if (!xf.ok) return 1;
    for (int64_t f = 0; f < n; ++f) {
        if (!xf.seek(offsets[f])) return 2;
        int32_t magic = xf.read_int();
        if (!xf.ok || magic != XTC_MAGIC) return 3;
        int32_t na = xf.read_int();
        if (na != n_atoms) return 4;
        int32_t st = xf.read_int();
        float tm = xf.read_float();
        for (int i = 0; i < 9; ++i) box[f * 9 + i] = xf.read_float();
        time[f] = tm;
        step[f] = st;
        if (decompress_coords(xf, xyz + (size_t)f * n_atoms * 3, n_atoms) < 0)
            return 5;
    }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// XTC writing (the 3dfcoord compressor)
// ---------------------------------------------------------------------------

namespace {

struct XdrOut {
    FILE* fp = nullptr;
    bool ok = true;

    explicit XdrOut(const char* path, bool append) {
        fp = std::fopen(path, append ? "ab" : "wb");
        ok = fp != nullptr;
    }
    ~XdrOut() { if (fp) std::fclose(fp); }

    void write_raw(const void* src, size_t n) {
        if (ok) ok = std::fwrite(src, 1, n, fp) == n;
    }
    void write_int(int32_t v) {
        unsigned char b[4] = {
            (unsigned char)((uint32_t)v >> 24), (unsigned char)((uint32_t)v >> 16),
            (unsigned char)((uint32_t)v >> 8), (unsigned char)v};
        write_raw(b, 4);
    }
    void write_float(float f) {
        uint32_t u;
        std::memcpy(&u, &f, 4);
        write_int((int32_t)u);
    }
};

struct BitWriter {
    std::vector<unsigned char> data;
    uint32_t cur = 0;  // bits buffered, MSB-first
    int nbits = 0;

    void write_bits(uint32_t value, int n) {
        for (int i = n - 1; i >= 0; --i) {
            cur = (cur << 1) | ((value >> i) & 1u);
            if (++nbits == 8) {
                data.push_back((unsigned char)cur);
                cur = 0;
                nbits = 0;
            }
        }
    }
    void flush() {
        if (nbits > 0) {
            data.push_back((unsigned char)(cur << (8 - nbits)));
            cur = 0;
            nbits = 0;
        }
    }
};

// Encode num_of_ints values as one mixed-radix big number in num_of_bits
// bits (inverse of decodeints; little-endian byte significance).
void encodeints(BitWriter& bw, int num_of_ints, int num_of_bits,
                const unsigned int sizes[], const int nums[]) {
    unsigned int bytes[32];
    int num_of_bytes = 0;
    // start with nums[0] in little-endian bytes
    unsigned int tmp = (unsigned int)nums[0];
    do {
        bytes[num_of_bytes++] = tmp & 0xff;
        tmp >>= 8;
    } while (tmp != 0);
    for (int i = 1; i < num_of_ints; ++i) {
        // bytes = bytes * sizes[i] + nums[i]
        unsigned int carry = (unsigned int)nums[i];
        for (int j = 0; j < num_of_bytes; ++j) {
            unsigned int t = bytes[j] * sizes[i] + carry;
            bytes[j] = t & 0xff;
            carry = t >> 8;
        }
        while (carry != 0) {
            bytes[num_of_bytes++] = carry & 0xff;
            carry >>= 8;
        }
    }
    // emit 8-bit groups little-significance-first, then the remainder
    int bits_left = num_of_bits;
    int idx = 0;
    while (bits_left > 8) {
        bw.write_bits(idx < num_of_bytes ? bytes[idx] : 0u, 8);
        ++idx;
        bits_left -= 8;
    }
    if (bits_left > 0) bw.write_bits(idx < num_of_bytes ? bytes[idx] : 0u, bits_left);
}

}  // namespace

namespace {

// Append one frame to an open file. Returns 0 on success.
int write_frame_impl(XdrOut& xf, int32_t n_atoms, int32_t step,
                     float time, const float* box /* 9 floats */,
                     const float* xyz /* n_atoms*3 */, float precision) {
    // non-finite coordinates would silently clamp into a 2^31-spanning
    // fixed-point range whose sizeofint degenerates to 0 bits — the frame
    // would read back as all-minint garbage. Refuse loudly instead.
    for (int i = 0; i < n_atoms * 3; ++i)
        if (!std::isfinite(xyz[i])) return 6;
    xf.write_int(XTC_MAGIC);
    xf.write_int(n_atoms);
    xf.write_int(step);
    xf.write_float(time);
    for (int i = 0; i < 9; ++i) xf.write_float(box[i]);
    xf.write_int(n_atoms);  // lsize

    if (n_atoms <= 9) {
        for (int i = 0; i < n_atoms * 3; ++i) xf.write_float(xyz[i]);
        return xf.ok ? 0 : 2;
    }

    if (precision <= 0) precision = 1000.0f;
    xf.write_float(precision);

    std::vector<int> ip((size_t)n_atoms * 3);
    int minint[3] = {INT32_MAX, INT32_MAX, INT32_MAX};
    int maxint[3] = {INT32_MIN, INT32_MIN, INT32_MIN};
    for (int i = 0; i < n_atoms; ++i) {
        for (int d = 0; d < 3; ++d) {
            float v = xyz[i * 3 + d] * precision;
            // clamp to the format's fixed-point range
            if (v > 2e9f) v = 2e9f;
            if (v < -2e9f) v = -2e9f;
            int iv = (int)std::lroundf(v);
            ip[(size_t)i * 3 + d] = iv;
            if (iv < minint[d]) minint[d] = iv;
            if (iv > maxint[d]) maxint[d] = iv;
        }
    }
    // refuse coordinate spans the fixed-point scheme cannot represent
    // (±2e6 nm at default precision — far beyond physical systems)
    for (int d = 0; d < 3; ++d)
        if ((int64_t)maxint[d] - (int64_t)minint[d] + 1 > (int64_t)1 << 30)
            return 7;
    for (int d = 0; d < 3; ++d) xf.write_int(minint[d]);
    for (int d = 0; d < 3; ++d) xf.write_int(maxint[d]);

    unsigned int sizeint[3], bitsizeint[3] = {0, 0, 0};
    for (int d = 0; d < 3; ++d)
        sizeint[d] = (unsigned int)(maxint[d] - minint[d]) + 1u;
    int bitsize;
    if ((sizeint[0] | sizeint[1] | sizeint[2]) > 0xffffff) {
        bitsizeint[0] = sizeofint((int)sizeint[0]);
        bitsizeint[1] = sizeofint((int)sizeint[1]);
        bitsizeint[2] = sizeofint((int)sizeint[2]);
        bitsize = 0;
    } else {
        bitsize = sizeofints(3, sizeint);
    }

    // simple encoder: no delta runs (flag = 0 with run length never set).
    // GROMACS tools read this fine — runs are an optional compression win,
    // not a format requirement. smallidx is still written for the header.
    int smallidx = FIRSTIDX;
    xf.write_int(smallidx);

    BitWriter bw;
    int prevrun = -1;
    (void)prevrun;
    for (int i = 0; i < n_atoms; ++i) {
        int this3[3] = {
            ip[(size_t)i * 3 + 0] - minint[0],
            ip[(size_t)i * 3 + 1] - minint[1],
            ip[(size_t)i * 3 + 2] - minint[2],
        };
        if (bitsize == 0) {
            bw.write_bits((uint32_t)this3[0], (int)bitsizeint[0]);
            bw.write_bits((uint32_t)this3[1], (int)bitsizeint[1]);
            bw.write_bits((uint32_t)this3[2], (int)bitsizeint[2]);
        } else {
            encodeints(bw, 3, bitsize, sizeint, this3);
        }
        // flag = 0: the previous run length (initially 0) is reused, i.e.
        // "no delta-encoded atoms follow this one"
        bw.write_bits(0u, 1);
    }
    bw.flush();

    xf.write_int((int32_t)bw.data.size());
    size_t padded = (bw.data.size() + 3) / 4 * 4;
    bw.data.resize(padded, 0);
    xf.write_raw(bw.data.data(), padded);
    return xf.ok ? 0 : 3;
}

}  // namespace

extern "C" {

// Append one frame. Returns 0 on success.
int xtc_write_frame(const char* path, int32_t n_atoms, int32_t step,
                    float time, const float* box /* 9 floats */,
                    const float* xyz /* n_atoms*3 */, float precision,
                    int32_t append) {
    XdrOut xf(path, append != 0);
    if (!xf.ok) return 1;
    return write_frame_impl(xf, n_atoms, step, time, box, xyz, precision);
}

// Write n frames in ONE open (the per-frame open/close of repeated
// xtc_write_frame calls dominated large saves). box: n*9, xyz: n*natoms*3.
// time/step may be null (frame index used). Returns 0 on success; on error
// the failing frame index is written to *err_frame.
int xtc_write_frames(const char* path, int32_t n_atoms, int64_t n,
                     const int32_t* step, const float* time,
                     const float* box, const float* xyz, float precision,
                     int64_t* err_frame) {
    XdrOut xf(path, false);
    if (!xf.ok) return 1;
    for (int64_t f = 0; f < n; ++f) {
        int rc = write_frame_impl(
            xf, n_atoms, step ? step[f] : (int32_t)f,
            time ? time[f] : (float)f, box + (size_t)f * 9,
            xyz + (size_t)f * n_atoms * 3, precision);
        if (rc != 0) {
            if (err_frame) *err_frame = f;
            return rc;
        }
    }
    return 0;
}

}  // extern "C"

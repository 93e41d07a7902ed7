// Native IO runtime: parallel region reads + inflate for the TIFF loader.
//
// The port's own copy of magnify_tpu/native/io_native.cpp. Decoding pages in
// a Python loop is bounded by interpreter overhead; this module is the
// package's native data-loader tier: a pthread pool pread()s many strip regions of a
// file concurrently (NVMe queues like depth) and optionally inflates
// DEFLATE-compressed strips with zlib, writing each region at its
// destination offset in a caller-provided buffer.
//
// Built on first use by magnify_tpu_torch.native (g++ -O3 -shared -fPIC -lz).

#include <cstdint>
#include <cstring>
#include <atomic>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>
#include <zlib.h>

namespace {

struct Task {
    int64_t src_offset;
    int64_t src_size;
    int64_t dst_offset;
    int64_t dst_size;
};

int read_exact(int fd, uint8_t* buf, int64_t size, int64_t offset) {
    int64_t done = 0;
    while (done < size) {
        ssize_t got = pread(fd, buf + done, size - done, offset + done);
        if (got <= 0) return -1;
        done += got;
    }
    return 0;
}

int inflate_region(const uint8_t* src, int64_t src_size, uint8_t* dst,
                   int64_t dst_size) {
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit(&zs) != Z_OK) return -1;
    zs.next_in = const_cast<Bytef*>(src);
    zs.avail_in = static_cast<uInt>(src_size);
    zs.next_out = dst;
    zs.avail_out = static_cast<uInt>(dst_size);
    int rc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    return (rc == Z_STREAM_END || rc == Z_OK) ? 0 : -1;
}

}  // namespace

extern "C" {

// Read n regions of `path` into `dst`. compression: 0 = raw copy,
// 8 = zlib/DEFLATE (TIFF compression tags 8/32946). Returns 0 on success.
int mgtpu_read_regions(const char* path, int64_t n,
                       const int64_t* src_offsets, const int64_t* src_sizes,
                       const int64_t* dst_offsets, const int64_t* dst_sizes,
                       uint8_t* dst, int compression, int n_threads) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;

    std::atomic<int64_t> next(0);
    std::atomic<int> status(0);
    if (n_threads < 1) n_threads = 1;
    if (n_threads > n) n_threads = static_cast<int>(n);

    auto worker = [&]() {
        std::vector<uint8_t> scratch;
        while (true) {
            int64_t i = next.fetch_add(1);
            if (i >= n || status.load() != 0) break;
            if (compression == 0) {
                if (read_exact(fd, dst + dst_offsets[i], src_sizes[i],
                               src_offsets[i]) != 0) {
                    status.store(-2);
                    break;
                }
            } else {
                scratch.resize(src_sizes[i]);
                if (read_exact(fd, scratch.data(), src_sizes[i],
                               src_offsets[i]) != 0) {
                    status.store(-2);
                    break;
                }
                if (inflate_region(scratch.data(), src_sizes[i],
                                   dst + dst_offsets[i], dst_sizes[i]) != 0) {
                    status.store(-3);
                    break;
                }
            }
        }
    };

    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
    close(fd);
    return status.load();
}

// Decode one LZ4 *block* (the codec inside blosc-lz4 zarr chunks; see
// magnify_tpu/io/zarrlite.py:_lz4_block_decompress for the format notes).
// Returns the decoded size, or a negative error: -1 truncated input,
// -2 bad match offset, -3 output overrun.
int64_t mgtpu_lz4_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                             int64_t cap) {
    int64_t pos = 0, out = 0;
    while (pos < n) {
        uint8_t token = src[pos++];
        int64_t lit = token >> 4;
        if (lit == 15) {
            uint8_t b;
            do {
                if (pos >= n) return -1;
                b = src[pos++];
                lit += b;
            } while (b == 255);
        }
        if (pos + lit > n) return -1;
        if (out + lit > cap) return -3;
        std::memcpy(dst + out, src + pos, lit);
        pos += lit;
        out += lit;
        if (pos >= n) break;  // last sequence carries no match
        if (pos + 2 > n) return -1;
        int64_t offset = src[pos] | (int64_t(src[pos + 1]) << 8);
        pos += 2;
        if (offset == 0 || offset > out) return -2;
        int64_t mlen = (token & 0xF) + 4;
        if ((token & 0xF) == 15) {
            uint8_t b;
            do {
                if (pos >= n) return -1;
                b = src[pos++];
                mlen += b;
            } while (b == 255);
        }
        if (out + mlen > cap) return -3;
        const uint8_t* from = dst + out - offset;
        if (offset >= mlen) {
            std::memcpy(dst + out, from, mlen);
        } else {
            // Overlapping self-copy: byte-wise semantics required.
            for (int64_t i = 0; i < mlen; ++i) dst[out + i] = from[i];
        }
        out += mlen;
    }
    return out;
}

int mgtpu_version() { return 2; }

}  // extern "C"

// Native capture reader: async-prefetch ring buffer for RTL-SDR captures.
//
// Native re-design of the reference's receiver layer (sdrrcv.c:3-107 +
// datathread, sdrmain.c:402-415): a producer pthread streams the uint8
// interleaved-I/Q file into a ring of fixed-size blocks, doing the byte
// work the device path leaves to the host (uint8 -> int8 via XOR 0x80, matching the
// -128 offset of sdrrcv.c:104-106, and optional deinterleave into planar
// I/Q planes — the layout the planar-complex device path ingests), and
// prepends an overlap-save halo of the previous block's tail so FFT /
// filter windows straddling block edges are exact (SURVEY.md §5
// time-block sharding).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this environment).
//
// Block layout returned to the consumer (n = halo + block samples):
//   planar=1: [ i0 i1 ... i_{n-1} | q0 q1 ... q_{n-1} ]   (2n int8)
//   planar=0: [ i0 q0 i1 q1 ... ]                          (2n int8)
// The first `halo` samples repeat the tail of the previous block
// (zero-filled for the first block).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Block {
  std::vector<int8_t> data;     // 2*(halo+block) int8
  int64_t sample_offset = 0;    // capture sample index of first POST-halo sample
  int64_t n_samples = 0;        // valid post-halo samples in this block
  bool ready = false;
};

struct Reader {
  FILE* f = nullptr;
  int64_t block = 0;            // samples per block (post-halo)
  int64_t halo = 0;             // halo samples carried from previous block
  int planar = 0;
  int n_buffers = 0;

  std::vector<Block> ring;
  int64_t head = 0;             // next block index to hand out
  int64_t tail = 0;             // next block index producer fills
  bool eof = false;
  std::atomic<bool> stop{false};

  std::mutex mu;
  std::condition_variable cv_producer;
  std::condition_variable cv_consumer;
  std::thread producer;

  std::vector<uint8_t> readbuf;   // raw bytes for one block
  std::vector<int8_t> halo_i;     // interleaved halo tail (2*halo int8)
};

void convert_block(Reader* r, Block& b, const uint8_t* raw, int64_t n,
                   const int8_t* halo_bytes) {
  const int64_t h = r->halo;
  const int64_t total = h + n;
  b.data.resize(2 * total);
  if (r->planar) {
    int8_t* ip = b.data.data();
    int8_t* qp = b.data.data() + total;
    for (int64_t k = 0; k < h; ++k) {       // halo is stored interleaved
      ip[k] = halo_bytes[2 * k];
      qp[k] = halo_bytes[2 * k + 1];
    }
    for (int64_t k = 0; k < n; ++k) {
      ip[h + k] = (int8_t)(raw[2 * k] ^ 0x80);
      qp[h + k] = (int8_t)(raw[2 * k + 1] ^ 0x80);
    }
  } else {
    std::memcpy(b.data.data(), halo_bytes, 2 * h);
    int8_t* out = b.data.data() + 2 * h;
    for (int64_t k = 0; k < 2 * n; ++k) out[k] = (int8_t)(raw[k] ^ 0x80);
  }
  b.n_samples = n;
}

void producer_loop(Reader* r) {
  int64_t offset = 0;
  while (!r->stop.load()) {
    size_t got = fread(r->readbuf.data(), 1, (size_t)(2 * r->block), r->f);
    int64_t n = (int64_t)(got / 2);
    if (n == 0) break;

    std::unique_lock<std::mutex> lk(r->mu);
    r->cv_producer.wait(lk, [r] {
      return r->stop.load() || (r->tail - r->head) < r->n_buffers;
    });
    if (r->stop.load()) break;
    Block& b = r->ring[r->tail % r->n_buffers];
    lk.unlock();

    convert_block(r, b, r->readbuf.data(), n, r->halo_i.data());
    b.sample_offset = offset;
    offset += n;
    // save tail for the next block's halo (converted, interleaved)
    const int64_t h = r->halo;
    if (h > 0 && n >= h) {
      for (int64_t k = 0; k < h; ++k) {
        r->halo_i[2 * k] = (int8_t)(r->readbuf[2 * (n - h + k)] ^ 0x80);
        r->halo_i[2 * k + 1] = (int8_t)(r->readbuf[2 * (n - h + k) + 1] ^ 0x80);
      }
    }

    lk.lock();
    b.ready = true;
    r->tail++;
    r->cv_consumer.notify_one();
    if (n < r->block) break;                 // short read = EOF
  }
  std::lock_guard<std::mutex> lk(r->mu);
  r->eof = true;
  r->cv_consumer.notify_all();
}

}  // namespace

extern "C" {

void* rdr_open(const char* path, int64_t block_samples, int64_t halo_samples,
               int n_buffers, int planar) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  Reader* r = new Reader();
  r->f = f;
  r->block = block_samples;
  r->halo = halo_samples;
  r->planar = planar;
  r->n_buffers = n_buffers > 1 ? n_buffers : 2;
  r->ring.resize(r->n_buffers);
  r->readbuf.resize((size_t)(2 * block_samples));
  r->halo_i.assign((size_t)(2 * halo_samples), 0);
  r->producer = std::thread(producer_loop, r);
  return r;
}

// Wait for the next block. Returns the number of valid post-halo samples,
// 0 on EOF. Fills *data (pointer valid until rdr_release) and
// *sample_offset (capture sample index of the first post-halo sample).
int64_t rdr_next(void* h, int8_t** data, int64_t* sample_offset) {
  Reader* r = (Reader*)h;
  std::unique_lock<std::mutex> lk(r->mu);
  r->cv_consumer.wait(lk, [r] {
    return r->head < r->tail || r->eof || r->stop.load();
  });
  if (r->head >= r->tail) return 0;          // EOF drained
  Block& b = r->ring[r->head % r->n_buffers];
  *data = b.data.data();
  *sample_offset = b.sample_offset;
  return b.n_samples;
}

// Mark the current block consumed, freeing its slot for the producer.
void rdr_release(void* h) {
  Reader* r = (Reader*)h;
  std::lock_guard<std::mutex> lk(r->mu);
  if (r->head < r->tail) {
    r->ring[r->head % r->n_buffers].ready = false;
    r->head++;
    r->cv_producer.notify_one();
  }
}

int64_t rdr_halo(void* h) { return ((Reader*)h)->halo; }
int64_t rdr_block(void* h) { return ((Reader*)h)->block; }

// Quantize + bit-pack `n_planes` contiguous int8 planes of `w` samples
// each into the BLOCK wire layout the device-side unpack expects
// (rx_stream._ingest: byte j of a plane carries samples {j + k*w*bits/8}
// — unpack is a pure concatenation of shifted planes, no interleave).
// lut is a 256-entry int8 quantizer table indexed by the raw byte's
// uint8 reinterpretation (the same `lut[w.view(uint8)]` contract as the
// numpy path). bits in {4, 2, 1}. One fused pass, no numpy temporaries,
// GIL-free under ctypes — the host pack drops off the IO worker's
// critical path at GLONASS rates (~80 MB windows).
void rdr_quantpack(const int8_t* in, int64_t n_planes, int64_t w,
                   const int8_t* lut, int bits, int8_t* out) {
  const int64_t ob = w * bits / 8;             // packed bytes per plane
  for (int64_t p = 0; p < n_planes; ++p) {
    const int8_t* src = in + p * w;
    int8_t* dst = out + p * ob;
    if (bits == 4) {
      const int64_t h = w / 2;
      for (int64_t j = 0; j < h; ++j) {
        const int8_t lo = lut[(uint8_t)src[j]];
        const int8_t hi = lut[(uint8_t)src[h + j]];
        dst[j] = (int8_t)((lo & 15) | (hi << 4));
      }
    } else if (bits == 2) {
      const int64_t q = w / 4;
      for (int64_t j = 0; j < q; ++j) {
        dst[j] = (int8_t)((lut[(uint8_t)src[j]] & 3)
                          | ((lut[(uint8_t)src[q + j]] & 3) << 2)
                          | ((lut[(uint8_t)src[2 * q + j]] & 3) << 4)
                          | (lut[(uint8_t)src[3 * q + j]] << 6));
      }
    } else {  // bits == 1: eight sign bits per byte
      const int64_t e = w / 8;
      for (int64_t j = 0; j < e; ++j) {
        int v = 0;
        for (int k = 0; k < 8; ++k)
          v |= (lut[(uint8_t)src[k * e + j]] & 1) << k;
        dst[j] = (int8_t)v;
      }
    }
  }
}

void rdr_close(void* h) {
  Reader* r = (Reader*)h;
  r->stop.store(true);
  r->cv_producer.notify_all();
  r->cv_consumer.notify_all();
  if (r->producer.joinable()) r->producer.join();
  fclose(r->f);
  delete r;
}

}  // extern "C"

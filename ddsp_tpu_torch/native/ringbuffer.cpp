// Lock-free single-producer single-consumer float ring buffer.
//
// The host-side hot path of the real-time runtime: the audio callback
// (producer/consumer on the JACK thread) exchanges sample blocks with the
// model worker thread without locks, allocation, or syscalls.  The
// reference's RT loop instead mutates Python globals from the audio thread
// and blocks the callback on GPU inference (reference: rt/synth.py:22-23,
// 40-56) -- both real-time hazards this component removes.
//
// A copy of ddsp_tpu/native/ringbuffer.cpp, so that ddsp_tpu_torch never
// loads the JAX package.  C API (ctypes-friendly): the Python binding is
// ddsp_tpu_torch/native/__init__.py, which builds this file with g++ at
// the first RingBuffer (or PCM conversion) and raises if the build fails;
// its Python ring runs only when asked for (force_python=True).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>

namespace {

struct RingBuffer {
  float* data;
  uint64_t capacity;  // power of two
  uint64_t mask;
  alignas(64) std::atomic<uint64_t> head;  // write position (producer)
  alignas(64) std::atomic<uint64_t> tail;  // read position (consumer)
};

uint64_t next_pow2(uint64_t n) {
  uint64_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

RingBuffer* rb_create(uint64_t min_capacity) {
  auto* rb = new (std::nothrow) RingBuffer;
  if (!rb) return nullptr;
  rb->capacity = next_pow2(min_capacity < 2 ? 2 : min_capacity);
  rb->mask = rb->capacity - 1;
  rb->data = new (std::nothrow) float[rb->capacity];
  if (!rb->data) {
    delete rb;
    return nullptr;
  }
  rb->head.store(0, std::memory_order_relaxed);
  rb->tail.store(0, std::memory_order_relaxed);
  return rb;
}

void rb_destroy(RingBuffer* rb) {
  if (!rb) return;
  delete[] rb->data;
  delete rb;
}

uint64_t rb_capacity(const RingBuffer* rb) { return rb->capacity; }

uint64_t rb_readable(const RingBuffer* rb) {
  return rb->head.load(std::memory_order_acquire) -
         rb->tail.load(std::memory_order_acquire);
}

uint64_t rb_writable(const RingBuffer* rb) {
  return rb->capacity - rb_readable(rb);
}

// Producer side: copy up to n samples in; returns samples written.
uint64_t rb_write(RingBuffer* rb, const float* src, uint64_t n) {
  const uint64_t head = rb->head.load(std::memory_order_relaxed);
  const uint64_t tail = rb->tail.load(std::memory_order_acquire);
  uint64_t space = rb->capacity - (head - tail);
  if (n > space) n = space;
  for (uint64_t i = 0; i < n; ++i) {
    rb->data[(head + i) & rb->mask] = src[i];
  }
  rb->head.store(head + n, std::memory_order_release);
  return n;
}

// Consumer side: copy up to n samples out; returns samples read.
uint64_t rb_read(RingBuffer* rb, float* dst, uint64_t n) {
  const uint64_t tail = rb->tail.load(std::memory_order_relaxed);
  const uint64_t head = rb->head.load(std::memory_order_acquire);
  uint64_t avail = head - tail;
  if (n > avail) n = avail;
  for (uint64_t i = 0; i < n; ++i) {
    dst[i] = rb->data[(tail + i) & rb->mask];
  }
  rb->tail.store(tail + n, std::memory_order_release);
  return n;
}

// Consumer peek without consuming (for overlapped analysis windows).
uint64_t rb_peek(RingBuffer* rb, float* dst, uint64_t n) {
  const uint64_t tail = rb->tail.load(std::memory_order_relaxed);
  const uint64_t head = rb->head.load(std::memory_order_acquire);
  uint64_t avail = head - tail;
  if (n > avail) n = avail;
  for (uint64_t i = 0; i < n; ++i) {
    dst[i] = rb->data[(tail + i) & rb->mask];
  }
  return n;
}

// --- PCM16 <-> float32 conversion (WAV codec hot loop) ---------------------

void pcm16_to_f32(const int16_t* src, float* dst, uint64_t n) {
  constexpr float kScale = 1.0f / 32768.0f;
  for (uint64_t i = 0; i < n; ++i) dst[i] = src[i] * kScale;
}

void f32_to_pcm16(const float* src, int16_t* dst, uint64_t n) {
  for (uint64_t i = 0; i < n; ++i) {
    float v = src[i] * 32767.0f;
    if (v > 32767.0f) v = 32767.0f;
    if (v < -32768.0f) v = -32768.0f;
    dst[i] = static_cast<int16_t>(v);
  }
}

}  // extern "C"

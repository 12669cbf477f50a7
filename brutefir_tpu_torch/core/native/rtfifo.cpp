// Lock-free SPSC byte rings + a pure-C JACK process callback.
//
// The reference's jack module (bfio_jack.c:133-174) runs its process
// callback entirely in C inside JACK's realtime thread. The Python
// bridge (io/callback.py) is correct but routes that callback through
// ctypes into the interpreter -- a GIL acquisition in a realtime audio
// thread, which is exactly where xruns come from. This module keeps the
// realtime path native: the callback interleaves JACK's planar float
// port buffers straight into wait-free single-producer/single-consumer
// rings; the engine's (non-realtime) threads drain them from Python.
//
// Memory ordering: each ring is strictly SPSC -- the JACK thread is the
// only producer of the capture ring and the only consumer of the
// playback ring; the engine thread is the opposite end. head/tail are
// monotonically increasing byte counters (wrap-around by modulo), so
// used() is head - tail with acquire loads.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>

namespace {

struct Ring {
    uint8_t *buf;
    size_t cap;
    std::atomic<uint64_t> head;   // bytes ever written (producer)
    std::atomic<uint64_t> tail;   // bytes ever read (consumer)
};

size_t ring_used(const Ring *r) {
    return (size_t)(r->head.load(std::memory_order_acquire)
                    - r->tail.load(std::memory_order_acquire));
}

size_t ring_write(Ring *r, const uint8_t *src, size_t n) {
    uint64_t head = r->head.load(std::memory_order_relaxed);
    uint64_t tail = r->tail.load(std::memory_order_acquire);
    size_t room = r->cap - (size_t)(head - tail);
    if (n > room) n = room;
    size_t pos = (size_t)(head % r->cap);
    size_t first = n < r->cap - pos ? n : r->cap - pos;
    memcpy(r->buf + pos, src, first);
    memcpy(r->buf, src + first, n - first);
    r->head.store(head + n, std::memory_order_release);
    return n;
}

size_t ring_read(Ring *r, uint8_t *dst, size_t n) {
    uint64_t head = r->head.load(std::memory_order_acquire);
    uint64_t tail = r->tail.load(std::memory_order_relaxed);
    size_t avail = (size_t)(head - tail);
    if (n > avail) n = avail;
    size_t pos = (size_t)(tail % r->cap);
    size_t first = n < r->cap - pos ? n : r->cap - pos;
    memcpy(dst, r->buf + pos, first);
    memcpy(dst + first, r->buf, n - first);
    r->tail.store(tail + n, std::memory_order_release);
    return n;
}

constexpr int MAX_PORTS = 64;

typedef void *(*get_buffer_fn)(void *port, uint32_t nframes);

struct JackCtx {
    get_buffer_fn get_buffer;
    int io;                       // 0 = engine input (capture from jack)
    int n_ports;
    void *ports[MAX_PORTS];
    Ring *ring;                   // interleaved f32 frames
    std::atomic<uint64_t> xruns;  // over- (capture) or under-runs (play)
    std::atomic<int> running;
    float scratch[MAX_PORTS];     // per-frame interleave staging
};

}  // namespace

extern "C" {

void *bf_ring_create(size_t cap) {
    Ring *r = new (std::nothrow) Ring;
    if (!r) return nullptr;
    r->buf = (uint8_t *)malloc(cap);
    if (!r->buf) { delete r; return nullptr; }
    r->cap = cap;
    r->head.store(0);
    r->tail.store(0);
    return r;
}

void bf_ring_destroy(void *ring) {
    Ring *r = (Ring *)ring;
    if (!r) return;
    free(r->buf);
    delete r;
}

uint64_t bf_ring_used(void *ring) { return ring_used((Ring *)ring); }

uint64_t bf_ring_write(void *ring, const uint8_t *src, uint64_t n) {
    return ring_write((Ring *)ring, src, (size_t)n);
}

uint64_t bf_ring_read(void *ring, uint8_t *dst, uint64_t n) {
    return ring_read((Ring *)ring, dst, (size_t)n);
}

void *bf_jack_ctx_create(void *get_buffer, int io, int n_ports,
                         void **ports, void *ring) {
    if (n_ports > MAX_PORTS) return nullptr;
    JackCtx *c = new (std::nothrow) JackCtx;
    if (!c) return nullptr;
    c->get_buffer = (get_buffer_fn)get_buffer;
    c->io = io;
    c->n_ports = n_ports;
    for (int i = 0; i < n_ports; i++) c->ports[i] = ports[i];
    c->ring = (Ring *)ring;
    c->xruns.store(0);
    c->running.store(1);
    return c;
}

void bf_jack_ctx_destroy(void *ctx) { delete (JackCtx *)ctx; }

void bf_jack_ctx_stop(void *ctx) {
    ((JackCtx *)ctx)->running.store(0, std::memory_order_release);
}

uint64_t bf_jack_ctx_xruns(void *ctx) {
    return ((JackCtx *)ctx)->xruns.load(std::memory_order_relaxed);
}

// The JACK process callback (realtime thread; no Python anywhere).
// Interleaves planar port buffers <-> the frame ring. A capture
// overflow drops the newest frames (the engine is behind); a playback
// shortfall plays silence -- both count as one xrun per period, the
// reference's synchronization-failure behavior (dai.c:1336-1369).
int bf_jack_process(uint32_t nframes, void *arg) {
    JackCtx *c = (JackCtx *)arg;
    if (!c) return 0;
    if (!c->running.load(std::memory_order_acquire)) {
        // a stopped playback stream must emit silence: JACK reuses port
        // buffers without clearing, so returning early would loop the
        // last written period until jack_deactivate
        if (c->io != 0) {
            for (int i = 0; i < c->n_ports; i++) {
                float *b = (float *)c->get_buffer(c->ports[i], nframes);
                if (b) memset(b, 0, (size_t)nframes * sizeof(float));
            }
        }
        return 0;
    }
    const int P = c->n_ports;
    float *bufs[MAX_PORTS];
    for (int i = 0; i < P; i++)
        bufs[i] = (float *)c->get_buffer(c->ports[i], nframes);
    const size_t framebytes = (size_t)P * sizeof(float);
    if (c->io == 0) {            // capture: ports -> ring
        bool over = false;
        for (uint32_t f = 0; f < nframes; f++) {
            // whole frames only: a partial write would shear the
            // interleave alignment for every later frame
            if (c->ring->cap - ring_used(c->ring) < framebytes) {
                over = true;
                break;
            }
            for (int i = 0; i < P; i++) c->scratch[i] = bufs[i][f];
            ring_write(c->ring, (const uint8_t *)c->scratch, framebytes);
        }
        if (over) c->xruns.fetch_add(1, std::memory_order_relaxed);
    } else {                     // playback: ring -> ports
        bool under = false;
        for (uint32_t f = 0; f < nframes; f++) {
            // whole frames only: a transiently part-written frame stays
            // in the ring until the engine completes it
            if (ring_used(c->ring) < framebytes) {
                under = true;
                for (int i = 0; i < P; i++)
                    for (uint32_t g = f; g < nframes; g++) bufs[i][g] = 0.0f;
                break;
            }
            ring_read(c->ring, (uint8_t *)c->scratch, framebytes);
            for (int i = 0; i < P; i++) bufs[i][f] = c->scratch[i];
        }
        if (under) c->xruns.fetch_add(1, std::memory_order_relaxed);
    }
    return 0;
}

}  // extern "C"

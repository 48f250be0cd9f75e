// Native host-runtime primitives (C++): the roles realtime_tools /
// ros_control play in the reference stack (QMController.h:111 RealtimeBuffer,
// MPC thread + executeAndSleep, QMController.cpp:310-335).
//
//  - seqlock SPSC mailbox: wait-free single-producer/single-consumer handoff
//    of fixed-size binary blobs (MPC policy snapshots -> control loop). The
//    reader never blocks the writer; torn reads are detected and retried.
//  - periodic executor timer: absolute-deadline clock_nanosleep loop with
//    overrun accounting (ocs2::executeAndSleep equivalent).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <new>

extern "C" {

// ---------------------------------------------------------------------------
// seqlock mailbox
// ---------------------------------------------------------------------------

struct Mailbox {
  std::atomic<uint64_t> seq;   // even = stable, odd = write in progress
  uint64_t capacity;
  uint64_t size;               // bytes of the last write
  alignas(64) uint8_t data[];  // flexible array member
};

Mailbox* qm_mailbox_create(uint64_t capacity) {
  void* mem = ::operator new(sizeof(Mailbox) + capacity, std::align_val_t(64),
                             std::nothrow);
  if (!mem) return nullptr;
  auto* mb = new (mem) Mailbox();
  mb->seq.store(0, std::memory_order_relaxed);
  mb->capacity = capacity;
  mb->size = 0;
  return mb;
}

void qm_mailbox_destroy(Mailbox* mb) {
  if (mb) {
    mb->~Mailbox();
    ::operator delete(mb, std::align_val_t(64), std::nothrow);
  }
}

// Producer: publish a new blob. Returns the new sequence number (even), or 0
// on overflow.
uint64_t qm_mailbox_write(Mailbox* mb, const uint8_t* src, uint64_t len) {
  if (len > mb->capacity) return 0;
  uint64_t s = mb->seq.load(std::memory_order_relaxed);
  mb->seq.store(s + 1, std::memory_order_release);  // mark write in progress
  std::atomic_thread_fence(std::memory_order_acquire);
  std::memcpy(mb->data, src, len);
  mb->size = len;
  std::atomic_thread_fence(std::memory_order_release);
  mb->seq.store(s + 2, std::memory_order_release);
  return s + 2;
}

// Consumer: read the latest blob. Returns the sequence number of the copy
// (even, monotonically increasing), or 0 if nothing published yet. Retries on
// torn reads; wait-free for the producer.
uint64_t qm_mailbox_read(Mailbox* mb, uint8_t* dst, uint64_t capacity,
                         uint64_t* out_len) {
  for (;;) {
    uint64_t s0 = mb->seq.load(std::memory_order_acquire);
    if (s0 == 0) return 0;        // never written
    if (s0 & 1) continue;         // write in progress, retry
    uint64_t len = mb->size;
    if (len > capacity) return 0;
    std::memcpy(dst, mb->data, len);
    std::atomic_thread_fence(std::memory_order_acquire);
    uint64_t s1 = mb->seq.load(std::memory_order_acquire);
    if (s0 == s1) {
      *out_len = len;
      return s1;
    }
    // torn read: writer intervened; retry
  }
}

uint64_t qm_mailbox_seq(Mailbox* mb) {
  return mb->seq.load(std::memory_order_acquire);
}

// ---------------------------------------------------------------------------
// periodic executor timer
// ---------------------------------------------------------------------------

struct PeriodicTimer {
  int64_t period_ns;
  struct timespec next;
  uint64_t ticks;
  uint64_t overruns;
  int64_t worst_lag_ns;
};

static inline int64_t ts_to_ns(const struct timespec& t) {
  return int64_t(t.tv_sec) * 1000000000LL + t.tv_nsec;
}

PeriodicTimer* qm_timer_create(int64_t period_ns) {
  auto* t = new (std::nothrow) PeriodicTimer();
  if (!t) return nullptr;
  t->period_ns = period_ns;
  clock_gettime(CLOCK_MONOTONIC, &t->next);
  t->ticks = 0;
  t->overruns = 0;
  t->worst_lag_ns = 0;
  return t;
}

void qm_timer_destroy(PeriodicTimer* t) { delete t; }

// Sleep until the next absolute deadline. Returns the lag (ns) relative to
// the deadline at wakeup (>= 0); deadlines missed by more than a period are
// skipped and counted as overruns.
int64_t qm_timer_wait(PeriodicTimer* t) {
  t->next.tv_nsec += t->period_ns;
  while (t->next.tv_nsec >= 1000000000L) {
    t->next.tv_nsec -= 1000000000L;
    t->next.tv_sec += 1;
  }
  struct timespec now;
  clock_gettime(CLOCK_MONOTONIC, &now);
  int64_t lag = ts_to_ns(now) - ts_to_ns(t->next);
  if (lag > t->period_ns) {
    // fell behind by more than one period: resynchronize
    t->overruns++;
    t->next = now;
    if (lag > t->worst_lag_ns) t->worst_lag_ns = lag;
    t->ticks++;
    return lag;
  }
  while (clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &t->next, nullptr)) {
  }
  clock_gettime(CLOCK_MONOTONIC, &now);
  lag = ts_to_ns(now) - ts_to_ns(t->next);
  if (lag > t->worst_lag_ns) t->worst_lag_ns = lag;
  t->ticks++;
  return lag;
}

uint64_t qm_timer_ticks(PeriodicTimer* t) { return t->ticks; }
uint64_t qm_timer_overruns(PeriodicTimer* t) { return t->overruns; }
int64_t qm_timer_worst_lag_ns(PeriodicTimer* t) { return t->worst_lag_ns; }

}  // extern "C"

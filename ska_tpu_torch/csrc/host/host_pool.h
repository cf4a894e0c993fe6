// Shared host-side thread-pool scaffolding for the native cores
// (skalo_core.cpp traversal + compaction walks, skalo_snps.cpp
// positioning). One definition so the clamp, the OOM disposition and
// the pthread_create fallback stay in lockstep across the pools.
// A copy of the JAX package's csrc/host_pool.h.
#pragma once

#include <atomic>
#include <cstdlib>
#include <new>
#include <stdexcept>
#include <system_error>
#include <thread>
#include <vector>

// host thread pool size: --threads N sets SKA_THREADS (ska_tpu/cli.py);
// the reference sizes a rayon pool the same way (read_graph.rs:37-40)
static inline int env_threads() {
    const char* s = getenv("SKA_THREADS");
    int t = s ? atoi(s) : 1;
    if (t < 1) t = 1;
    if (t > 256) t = 256;
    return t;
}

// Work-stealing parallel-for over [0, n): T-1 spawned workers plus the
// calling thread claim items from a shared atomic counter; each worker
// owns a State built by make_state() and runs body(state, i) per item.
// Allocation failures (bad_alloc / length_error) stop all workers and
// rethrow as bad_alloc after the join — the native entry points
// translate that into a clean MemoryError. If pthread_create fails
// (e.g. a tight RLIMIT), whatever threads did start plus the calling
// thread still drain the queue. Determinism contract: body(i) must
// write only to item i's own result slot(s); callers concatenate slots
// in item order afterwards.
template <class MakeState, class Body>
inline void pool_for_each(size_t n, int T, MakeState make_state, Body body) {
    std::atomic<size_t> next{0};
    std::atomic<bool> oom{false};
    auto worker = [&]() {
        try {
            auto state = make_state();
            for (;;) {
                if (oom.load(std::memory_order_relaxed)) break;
                size_t i = next.fetch_add(1, std::memory_order_relaxed);
                if (i >= n) break;
                body(state, i);
            }
        } catch (const std::bad_alloc&) {
            oom.store(true);
        } catch (const std::length_error&) {
            oom.store(true);
        }
    };
    std::vector<std::thread> pool;
    if (T > 1) {
        pool.reserve((size_t)T - 1);
        try {
            for (int t2 = 0; t2 < T - 1; t2++) pool.emplace_back(worker);
        } catch (const std::system_error&) {
            // pthread_create failed: proceed with the threads that did
            // start — the calling thread still works
        }
    }
    worker();
    for (auto& th : pool) th.join();
    if (oom.load()) throw std::bad_alloc();
}

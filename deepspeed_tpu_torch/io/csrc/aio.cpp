// Native async file I/O engine (DeepNVMe / csrc/aio equivalent).
//
// The port's own copy of deepspeed_tpu/io/csrc/aio.cpp, unchanged in
// behaviour; io/aio.py builds it with g++ at first use.
//
// Re-design of the reference's deepspeed_aio_thread / py_ds_aio stack
// (csrc/aio/py_lib/deepspeed_py_io_handle.cpp, deepspeed_aio_thread.cpp,
// libaio submit path deepspeed_aio_common.cpp): a persistent pthread
// pool executes I/O jobs; each submitted job is SPLIT across the pool in
// block_size chunks (the reference's parallel single-tensor I/O),
// completion is tracked per job id, and waiters block on a condition
// variable.
//
// Each worker drives its chunk through a private io_uring (raw syscalls
// — no liburing in the image) with queue_depth block-size ops in flight,
// the host equivalent of the reference's libaio queue_depth: device
// parallelism comes from ring depth, not thread count, so one core
// saturates an NVMe.  Falls back to pread/pwrite loops when the kernel
// lacks io_uring.
//
// Write path is built for READ PARITY (the reference's ds_io target):
// files are preallocated (fallocate) before parallel chunk writes so no
// worker stalls on extent allocation, chunk boundaries are
// kDirectAlign-aligned, and O_DIRECT is honored whenever pointer+offset
// are aligned — an unaligned LENGTH splits into an aligned O_DIRECT
// main body plus a small buffered tail (disjoint byte ranges, so the
// mixed-mode coherence caveat doesn't bite), instead of silently
// degrading the whole chunk to buffered I/O like the old per-chunk
// all-or-nothing check.  A fully unaligned pointer falls back to
// buffered I/O (the reference's bounce-buffer path; callers that want
// O_DIRECT allocate via the Python-side aligned_empty()).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <linux/io_uring.h>
#include <memory>
#include <mutex>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

constexpr size_t kDirectAlign = 4096;

struct Job {
    std::atomic<int> remaining{0};
    std::atomic<int> status{0};        // 0 ok, negative errno of first fail
};

struct Chunk {
    std::shared_ptr<Job> job;
    bool write;
    std::string path;
    char* buf;
    size_t nbytes;
    size_t offset;                      // file offset
    bool use_odirect;
};

// ---------------------------------------------------------------------------
// Minimal io_uring wrapper (raw syscalls)
// ---------------------------------------------------------------------------

int sys_io_uring_setup(unsigned entries, io_uring_params* p) {
    return (int)syscall(__NR_io_uring_setup, entries, p);
}

int sys_io_uring_enter(int fd, unsigned to_submit, unsigned min_complete,
                       unsigned flags) {
    return (int)syscall(__NR_io_uring_enter, fd, to_submit, min_complete,
                        flags, nullptr, 0);
}

struct Ring {
    int fd = -1;
    unsigned entries = 0;
    // submission queue
    unsigned* sq_head = nullptr;
    unsigned* sq_tail = nullptr;
    unsigned* sq_mask = nullptr;
    unsigned* sq_array = nullptr;
    io_uring_sqe* sqes = nullptr;
    // completion queue
    unsigned* cq_head = nullptr;
    unsigned* cq_tail = nullptr;
    unsigned* cq_mask = nullptr;
    io_uring_cqe* cqes = nullptr;
    void* sq_ptr = nullptr;
    void* cq_ptr = nullptr;
    size_t sq_len = 0, cq_len = 0, sqe_len = 0;

    bool init(unsigned depth) {
        io_uring_params p;
        memset(&p, 0, sizeof(p));
        fd = sys_io_uring_setup(depth, &p);
        if (fd < 0) return false;
        entries = p.sq_entries;
        sq_len = p.sq_off.array + p.sq_entries * sizeof(unsigned);
        cq_len = p.cq_off.cqes + p.cq_entries * sizeof(io_uring_cqe);
        bool single_mmap = p.features & IORING_FEAT_SINGLE_MMAP;
        if (single_mmap && cq_len > sq_len) sq_len = cq_len;
        sq_ptr = mmap(nullptr, sq_len, PROT_READ | PROT_WRITE,
                      MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_SQ_RING);
        if (sq_ptr == MAP_FAILED) { close(); return false; }
        cq_ptr = sq_ptr;
        if (!single_mmap) {
            cq_ptr = mmap(nullptr, cq_len, PROT_READ | PROT_WRITE,
                          MAP_SHARED | MAP_POPULATE, fd,
                          IORING_OFF_CQ_RING);
            if (cq_ptr == MAP_FAILED) { close(); return false; }
        }
        sqe_len = p.sq_entries * sizeof(io_uring_sqe);
        sqes = (io_uring_sqe*)mmap(nullptr, sqe_len,
                                   PROT_READ | PROT_WRITE,
                                   MAP_SHARED | MAP_POPULATE, fd,
                                   IORING_OFF_SQES);
        if (sqes == MAP_FAILED) { sqes = nullptr; close(); return false; }
        auto* sq = (char*)sq_ptr;
        sq_head = (unsigned*)(sq + p.sq_off.head);
        sq_tail = (unsigned*)(sq + p.sq_off.tail);
        sq_mask = (unsigned*)(sq + p.sq_off.ring_mask);
        sq_array = (unsigned*)(sq + p.sq_off.array);
        auto* cq = (char*)cq_ptr;
        cq_head = (unsigned*)(cq + p.cq_off.head);
        cq_tail = (unsigned*)(cq + p.cq_off.tail);
        cq_mask = (unsigned*)(cq + p.cq_off.ring_mask);
        cqes = (io_uring_cqe*)(cq + p.cq_off.cqes);
        return true;
    }

    void close() {
        if (sqes) munmap(sqes, sqe_len);
        if (cq_ptr && cq_ptr != sq_ptr) munmap(cq_ptr, cq_len);
        if (sq_ptr) munmap(sq_ptr, sq_len);
        if (fd >= 0) ::close(fd);
        fd = -1; sq_ptr = cq_ptr = nullptr; sqes = nullptr;
    }

    ~Ring() { close(); }
};

struct PendingOp {
    char* buf;
    size_t len;
    size_t off;
};

// Drive one chunk through a ring: block_size ops, queue_depth in flight,
// short transfers resubmitted.  Returns 0 or -errno.  On error, stops
// submitting but DRAINS every in-flight completion before returning —
// the ring is thread_local and reused (e.g. by the O_DIRECT buffered
// retry); returning with ops in flight would let stale completions
// collide with the next run's user_data slots and touch buffers the
// caller may have freed.
int uring_rw(Ring& ring, int fd, bool write, char* buf, size_t nbytes,
             size_t file_off, size_t block, unsigned depth) {
    size_t next = 0;                    // next byte to enqueue
    size_t inflight = 0;
    int first_err = 0;
    std::vector<PendingOp> ops(ring.entries);
    std::vector<unsigned> free_slots;
    for (unsigned i = 0; i < ring.entries; ++i) free_slots.push_back(i);
    unsigned to_submit = 0;

    auto push = [&](unsigned slot, char* b, size_t len, size_t off) {
        ops[slot] = {b, len, off};
        unsigned tail = *ring.sq_tail;
        unsigned idx = tail & *ring.sq_mask;
        io_uring_sqe* sqe = &ring.sqes[idx];
        memset(sqe, 0, sizeof(*sqe));
        sqe->opcode = write ? IORING_OP_WRITE : IORING_OP_READ;
        sqe->fd = fd;
        sqe->addr = (uint64_t)b;
        sqe->len = (unsigned)len;
        sqe->off = off;
        sqe->user_data = slot;
        ring.sq_array[idx] = idx;
        __atomic_store_n(ring.sq_tail, tail + 1, __ATOMIC_RELEASE);
        ++to_submit;
        ++inflight;
    };

    while (next < nbytes || inflight > 0) {
        while (first_err == 0 && next < nbytes && !free_slots.empty() &&
               inflight < (size_t)depth) {
            size_t len = std::min(block, nbytes - next);
            unsigned slot = free_slots.back();
            free_slots.pop_back();
            push(slot, buf + next, len, file_off + next);
            next += len;
        }
        if (inflight == 0) break;
        int r = sys_io_uring_enter(ring.fd, to_submit, 1,
                                   IORING_ENTER_GETEVENTS);
        if (r < 0) {
            if (errno == EINTR) continue;
            // enter itself failed: ops submitted so far are still in
            // flight only if a previous enter succeeded; without a way
            // to reap, poison the ring so it is rebuilt next use
            if (first_err == 0) first_err = -errno;
            ring.close();
            return first_err;
        }
        to_submit = 0;
        // reap
        unsigned head = *ring.cq_head;
        unsigned tail = __atomic_load_n(ring.cq_tail, __ATOMIC_ACQUIRE);
        while (head != tail) {
            io_uring_cqe* cqe = &ring.cqes[head & *ring.cq_mask];
            unsigned slot = (unsigned)cqe->user_data;
            int res = cqe->res;
            PendingOp op = ops[slot];
            ++head;
            --inflight;
            if (res < 0) {
                if (first_err == 0) first_err = res;
                free_slots.push_back(slot);
            } else if (res == 0 && op.len > 0) {
                if (first_err == 0) first_err = -EIO;  // unexpected EOF
                free_slots.push_back(slot);
            } else if ((size_t)res < op.len && first_err == 0) {
                // short transfer: resubmit the remainder
                push(slot, op.buf + res, op.len - (size_t)res,
                     op.off + (size_t)res);
            } else {
                free_slots.push_back(slot);
            }
            __atomic_store_n(ring.cq_head, head, __ATOMIC_RELEASE);
            tail = __atomic_load_n(ring.cq_tail, __ATOMIC_ACQUIRE);
        }
    }
    return first_err;
}

struct Handle {
    int nthreads;
    size_t block_size;
    bool use_odirect;
    int backend;                        // 0 pread/pwrite, 1 io_uring
    unsigned queue_depth;
    std::vector<std::thread> workers;
    std::deque<Chunk> queue;
    std::mutex mu;
    std::condition_variable cv;
    std::condition_variable done_cv;
    std::unordered_map<int64_t, std::shared_ptr<Job>> jobs;
    std::mutex jobs_mu;
    std::atomic<int64_t> next_id{1};
    bool stopping = false;

    // running totals (reference io_op_desc_t stats)
    std::atomic<int64_t> bytes_read{0};
    std::atomic<int64_t> bytes_written{0};
};

bool uring_available() {
    static int avail = -1;
    if (avail < 0) {
        io_uring_params p;
        memset(&p, 0, sizeof(p));
        int fd = sys_io_uring_setup(1, &p);
        if (fd >= 0) { ::close(fd); avail = 1; } else avail = 0;
    }
    return avail == 1;
}

int open_file(const std::string& path, bool write, bool odirect) {
    int flags = write ? (O_WRONLY | O_CREAT) : O_RDONLY;
    if (odirect) {
        int fd = ::open(path.c_str(), flags | O_DIRECT, 0644);
        if (fd >= 0) return fd;
        // fall back to buffered I/O (reference bounce-buffer path)
    }
    return ::open(path.c_str(), flags, 0644);
}

// pread/pwrite loop over [off, off+len) of the user buffer
int plain_rw(int fd, bool write, char* buf, size_t len, size_t file_off) {
    size_t done = 0;
    while (done < len) {
        ssize_t n = write
            ? ::pwrite(fd, buf + done, len - done, (off_t)(file_off + done))
            : ::pread(fd, buf + done, len - done, (off_t)(file_off + done));
        if (n < 0) { if (errno == EINTR) continue; return -errno; }
        if (n == 0) return -EIO;            // short read / no space
        done += (size_t)n;
    }
    return 0;
}

// drive [0, len) of c through this worker's ring (falling back to the
// pread/pwrite loop where the kernel lacks usable io_uring), against fd
int engine_rw(Handle* h, int fd, const Chunk& c, char* buf, size_t len,
              size_t file_off) {
    int status = -ENOSYS;
    if (h->backend == 1) {
        thread_local Ring ring;
        thread_local unsigned ring_depth = 0;
        if (ring.fd < 0 || ring_depth != h->queue_depth) {
            ring.close();
            if (ring.init(h->queue_depth)) ring_depth = h->queue_depth;
        }
        if (ring.fd >= 0)
            status = uring_rw(ring, fd, c.write, buf, len, file_off,
                              h->block_size, h->queue_depth);
    }
    // -EINVAL / -EOPNOTSUPP: kernels 5.1-5.5 pass the io_uring_setup
    // probe but lack IORING_OP_READ/WRITE (5.6+) and fail per-op —
    // fall back to the pread/pwrite loop on the SAME fd (alignment
    // constraints are identical; O_DIRECT refusal is handled one level
    // up with a buffered reopen)
    if (status == -ENOSYS || status == -EOPNOTSUPP)
        status = plain_rw(fd, c.write, buf, len, file_off);
    return status;
}

void run_chunk(Handle* h, Chunk& c) {
    // O_DIRECT needs aligned pointer/offset/length.  Pointer+offset
    // alignment is required up front; an unaligned length only demotes
    // the TAIL (the sub-kDirectAlign remainder) to buffered I/O — the
    // aligned main body still bypasses the page cache, which is where
    // write parity with the read path comes from on NVMe.
    bool head_ok = ((uintptr_t)c.buf % kDirectAlign == 0) &&
                   (c.offset % kDirectAlign == 0);
    size_t main_len = c.nbytes & ~(kDirectAlign - 1);
    bool odirect = c.use_odirect && head_ok && main_len > 0;
    size_t tail = odirect ? c.nbytes - main_len : 0;
    int fd = open_file(c.path, c.write, odirect);
    int status = 0;
    if (fd < 0) {
        status = -errno;
    } else {
        size_t drive_len = odirect ? main_len : c.nbytes;
        status = engine_rw(h, fd, c, c.buf, drive_len, c.offset);
        if (status == -EINVAL && odirect) {
            // the fs accepted O_DIRECT at open but refuses the ops
            // (e.g. tmpfs quirks, fs-specific alignment > 4096):
            // buffered retry of the WHOLE chunk, tail included
            ::close(fd);
            tail = 0;
            fd = open_file(c.path, c.write, false);
            status = fd < 0 ? -errno
                : engine_rw(h, fd, c, c.buf, c.nbytes, c.offset);
        }
        if (status == 0 && tail > 0) {
            // buffered tail on a separate fd: its byte range is
            // disjoint from every O_DIRECT range in this job (chunk
            // boundaries are kDirectAlign-aligned), so page-cache vs
            // direct coherence never overlaps
            int tfd = open_file(c.path, c.write, false);
            status = tfd < 0 ? -errno
                : plain_rw(tfd, c.write, c.buf + main_len, tail,
                           c.offset + main_len);
            if (tfd >= 0) ::close(tfd);
        }
        if (fd >= 0) ::close(fd);
        if (status == 0) {
            if (c.write) h->bytes_written += (int64_t)c.nbytes;
            else         h->bytes_read    += (int64_t)c.nbytes;
        }
    }
    if (status != 0) {
        int expected = 0;
        c.job->status.compare_exchange_strong(expected, status);
    }
    if (c.job->remaining.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> lk(h->mu);
        h->done_cv.notify_all();
    }
}

void worker_loop(Handle* h) {
    for (;;) {
        Chunk c;
        {
            std::unique_lock<std::mutex> lk(h->mu);
            h->cv.wait(lk, [h] { return h->stopping || !h->queue.empty(); });
            if (h->stopping && h->queue.empty()) return;
            c = std::move(h->queue.front());
            h->queue.pop_front();
        }
        run_chunk(h, c);
    }
}

int64_t submit(Handle* h, bool write, const char* path, void* buf,
               size_t nbytes, size_t offset) {
    auto job = std::make_shared<Job>();
    // split across the pool in block_size chunks, at most nthreads ways
    size_t nchunks = 1;
    if (nbytes > h->block_size) {
        nchunks = (nbytes + h->block_size - 1) / h->block_size;
        if (nchunks > (size_t)h->nthreads) nchunks = (size_t)h->nthreads;
    }
    size_t per = (nbytes + nchunks - 1) / nchunks;
    // O_DIRECT needs kDirectAlign-aligned chunk boundaries (offsets are
    // base + k*per, so aligning per keeps every non-tail chunk eligible
    // for the direct path, not just 512-sector-aligned ones)
    if (h->use_odirect && per % kDirectAlign)
        per += kDirectAlign - per % kDirectAlign;
    std::vector<Chunk> chunks;
    for (size_t off = 0; off < nbytes; off += per) {
        Chunk c;
        c.job = job;
        c.write = write;
        c.path = path;
        c.buf = (char*)buf + off;
        c.nbytes = std::min(per, nbytes - off);
        c.offset = offset + off;
        c.use_odirect = h->use_odirect;
        chunks.push_back(std::move(c));
    }
    job->remaining = (int)chunks.size();
    int64_t id = h->next_id.fetch_add(1);
    {
        std::lock_guard<std::mutex> lk(h->jobs_mu);
        h->jobs[id] = job;
    }
    {
        std::lock_guard<std::mutex> lk(h->mu);
        for (auto& c : chunks) h->queue.push_back(std::move(c));
    }
    h->cv.notify_all();
    return id;
}

std::shared_ptr<Job> find_job(Handle* h, int64_t id) {
    std::lock_guard<std::mutex> lk(h->jobs_mu);
    auto it = h->jobs.find(id);
    return it == h->jobs.end() ? nullptr : it->second;
}

}  // namespace

extern "C" {

// backend: 0 = pread/pwrite thread pool, 1 = io_uring, -1 = auto
// (io_uring when the kernel supports it)
void* aio_create2(int num_threads, int64_t block_size, int use_odirect,
                  int backend, int queue_depth) {
    auto* h = new Handle();
    h->nthreads = num_threads > 0 ? num_threads : 1;
    h->block_size = block_size > 0 ? (size_t)block_size : (1u << 20);
    h->use_odirect = use_odirect != 0;
    if (backend < 0) backend = uring_available() ? 1 : 0;
    if (backend == 1 && !uring_available()) backend = 0;
    h->backend = backend;
    h->queue_depth = queue_depth > 0 ? (unsigned)queue_depth : 64u;
    for (int i = 0; i < h->nthreads; ++i)
        h->workers.emplace_back(worker_loop, h);
    return h;
}

void* aio_create(int num_threads, int64_t block_size, int use_odirect) {
    return aio_create2(num_threads, block_size, use_odirect, -1, 64);
}

int aio_backend(void* hp) { return ((Handle*)hp)->backend; }

void aio_destroy(void* hp) {
    auto* h = (Handle*)hp;
    {
        std::lock_guard<std::mutex> lk(h->mu);
        h->stopping = true;
    }
    h->cv.notify_all();
    for (auto& t : h->workers) t.join();
    delete h;
}

int64_t aio_submit_read(void* hp, const char* path, void* buf,
                        int64_t nbytes, int64_t offset) {
    return submit((Handle*)hp, false, path, buf, (size_t)nbytes,
                  (size_t)offset);
}

int64_t aio_submit_write(void* hp, const char* path, void* buf,
                         int64_t nbytes, int64_t offset) {
    return submit((Handle*)hp, true, path, buf, (size_t)nbytes,
                  (size_t)offset);
}

// -1 = still pending; otherwise job status (0 ok / -errno)
int aio_poll(void* hp, int64_t id) {
    auto* h = (Handle*)hp;
    auto job = find_job(h, id);
    if (!job) return -EINVAL;
    if (job->remaining.load() > 0) return -1;
    return job->status.load();
}

int aio_wait(void* hp, int64_t id) {
    auto* h = (Handle*)hp;
    auto job = find_job(h, id);
    if (!job) return -EINVAL;
    {
        std::unique_lock<std::mutex> lk(h->mu);
        h->done_cv.wait(lk, [&] { return job->remaining.load() == 0; });
    }
    int st = job->status.load();
    {
        std::lock_guard<std::mutex> lk(h->jobs_mu);
        h->jobs.erase(id);
    }
    return st;
}

int aio_pread(void* hp, const char* path, void* buf, int64_t nbytes,
              int64_t offset) {
    return aio_wait(hp, aio_submit_read(hp, path, buf, nbytes, offset));
}

int aio_pwrite(void* hp, const char* path, void* buf, int64_t nbytes,
               int64_t offset) {
    return aio_wait(hp, aio_submit_write(hp, path, buf, nbytes, offset));
}

int64_t aio_bytes_read(void* hp) { return ((Handle*)hp)->bytes_read.load(); }
int64_t aio_bytes_written(void* hp) {
    return ((Handle*)hp)->bytes_written.load();
}
int64_t aio_file_size(const char* path) {
    struct stat st;
    if (::stat(path, &st) != 0) return -errno;
    return (int64_t)st.st_size;
}

// Extend-only preallocation: size the file AND reserve its extents
// before parallel chunk writes, so no worker stalls inside the fs
// allocator mid-stream (the reference preallocates its swap buffers the
// same way).  Never shrinks.  Returns 0 or -errno.
int aio_prealloc(const char* path, int64_t size) {
    int fd = ::open(path, O_WRONLY | O_CREAT, 0644);
    if (fd < 0) return -errno;
    int status = 0;
    struct stat st;
    if (::fstat(fd, &st) != 0) {
        status = -errno;
    } else if (st.st_size < size) {
        int rc = ::posix_fallocate(fd, 0, size);
        // fs without fallocate support (e.g. some overlay/tmpfs): a
        // plain size extension still gives parallel writers a stable
        // file length (extents then allocate lazily)
        if (rc != 0 && ::ftruncate(fd, size) != 0) status = -errno;
    }
    ::close(fd);
    return status;
}

}  // extern "C"

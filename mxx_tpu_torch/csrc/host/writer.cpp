// Host asynchronous artifact writer.
//
// Derived from the JAX package's `native/writer.cpp`, built separately for the
// port (mxx_tpu_torch/native/writer.py): a pool of worker threads drains a
// queue of (path, bytes) jobs; `mxx_writer_wait_all` is the completion
// barrier. Plain C ABI, loaded with ctypes.
//
// Where it departs from that copy: its only entry, `mxx_writer_submit_parts`,
// queues a file made of several buffers WITHOUT copying them, so a queued
// multi-gigabyte batch file costs no second host copy. Each job carries the
// caller's sequence number; once the job's file is written (or has failed),
// `mxx_writer_take_done` hands that number back, and the caller, which kept
// the buffers alive until then, lets them go.
//
// Build: g++ -O3 -shared -fPIC -pthread -o libwriter.so writer.cpp

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Job {
    std::string path;
    std::vector<std::pair<const uint8_t*, uint64_t>> parts;  // borrowed payload
    uint64_t seq = 0;
};

class Writer {
  public:
    explicit Writer(unsigned workers) : pending_(0), stop_(false) {
        for (unsigned i = 0; i < workers; ++i) {
            threads_.emplace_back([this] { this->run(); });
        }
    }

    ~Writer() {
        {
            std::unique_lock<std::mutex> lk(mu_);
            stop_ = true;
        }
        cv_.notify_all();
        for (auto& t : threads_) t.join();
    }

    void submit_parts(const char* path, const uint8_t* const* datas, const uint64_t* lens,
                      uint32_t count, uint64_t seq) {
        Job job;
        job.path = path;
        job.seq = seq;
        for (uint32_t i = 0; i < count; ++i) job.parts.emplace_back(datas[i], lens[i]);
        {
            std::unique_lock<std::mutex> lk(mu_);
            ++pending_;
            queue_.push(std::move(job));
        }
        cv_.notify_one();
    }

    uint32_t take_done(uint64_t* out, uint32_t cap) {
        std::unique_lock<std::mutex> lk(mu_);
        uint32_t n = 0;
        while (n < cap && !done_.empty()) {
            out[n++] = done_.back();
            done_.pop_back();
        }
        return n;
    }

    void wait_all() {
        std::unique_lock<std::mutex> lk(mu_);
        done_cv_.wait(lk, [this] { return pending_ == 0; });
    }

    uint64_t errors() {
        std::unique_lock<std::mutex> lk(mu_);
        return errors_;
    }

  private:
    void run() {
        for (;;) {
            Job job;
            {
                std::unique_lock<std::mutex> lk(mu_);
                cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
                if (stop_ && queue_.empty()) return;
                job = std::move(queue_.front());
                queue_.pop();
            }
            // Crash-safe: write the full payload to a temp path, then rename
            // atomically, so a reader (or a resumed run) never observes a
            // partially written artifact.
            const std::string tmp = job.path + ".tmp";
            bool ok = false;
            FILE* f = std::fopen(tmp.c_str(), "wb");
            if (f != nullptr) {
                ok = true;
                for (const auto& part : job.parts) {
                    ok = ok && std::fwrite(part.first, 1, part.second, f) == part.second;
                }
                ok = (std::fclose(f) == 0) && ok;
                if (!ok || std::rename(tmp.c_str(), job.path.c_str()) != 0) {
                    ok = false;
                    std::remove(tmp.c_str());
                }
            }
            {
                std::unique_lock<std::mutex> lk(mu_);
                if (!ok) ++errors_;
                done_.push_back(job.seq);
                if (--pending_ == 0) done_cv_.notify_all();
            }
        }
    }

    std::mutex mu_;
    std::condition_variable cv_;
    std::condition_variable done_cv_;
    std::queue<Job> queue_;
    std::vector<uint64_t> done_;  // sequence numbers of finished jobs, not yet taken
    std::vector<std::thread> threads_;
    uint64_t pending_;
    bool stop_;
    uint64_t errors_ = 0;
};

Writer* g_writer = nullptr;
std::mutex g_init_mu;

}  // namespace

extern "C" {

void mxx_writer_init(uint32_t workers) {
    std::lock_guard<std::mutex> lk(g_init_mu);
    if (g_writer == nullptr) {
        g_writer = new Writer(workers == 0 ? 4 : workers);
    }
}

void mxx_writer_submit_parts(const char* path, const uint8_t* const* datas,
                             const uint64_t* lens, uint32_t count, uint64_t seq) {
    if (g_writer == nullptr) mxx_writer_init(0);
    g_writer->submit_parts(path, datas, lens, count, seq);
}

uint32_t mxx_writer_take_done(uint64_t* out, uint32_t cap) {
    return g_writer == nullptr ? 0 : g_writer->take_done(out, cap);
}

void mxx_writer_wait_all() {
    if (g_writer != nullptr) g_writer->wait_all();
}

uint64_t mxx_writer_errors() {
    return g_writer == nullptr ? 0 : g_writer->errors();
}

}  // extern "C"

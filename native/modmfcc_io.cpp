// modmfcc_io — native host-side audio runtime for modulation_mfcc.
//
// The feature pipelines run on the accelerator; the host's job is to keep it fed
// (SURVEY.md §7: "the bottleneck is host I/O + resampling"). This library
// provides the native equivalents of the Python io/wav.py path:
//
//   * WAV decode (PCM 8/16/24/32, float32/64) → float32 in [-1, 1)
//   * polyphase FIR resampling with caller-supplied taps (designed by
//     scipy host-side, so numeric parity with resample_poly is testable)
//   * a multithreaded batch loader: worker threads decode+resample files
//     while the caller drains ready results — decouples Python from disk
//
// C API only (ctypes-friendly); no Python.h dependency.
//
// Build: make -C native   (produces libmodmfcc_io.so)

#include <atomic>
#include <condition_variable>
#include <map>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Decoded {
  std::vector<float> samples;  // mono (first channel)
  // filled INSTEAD of `samples` for 16-bit PCM sources when the caller
  // asked for passthrough (see decode_wav want_i16): the int16 grid is the
  // corpus upload format, so skipping the float conversion here removes
  // two full passes over the audio on the (single-core) host — the
  // float32 path and the downstream on-grid re-check both disappear.
  std::vector<int16_t> samples_i16;
  int sample_rate = 0;
  std::string error;
};

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) { return (uint16_t)(p[0] | (p[1] << 8)); }

Decoded decode_wav(const char* path, bool want_i16 = false) {
  Decoded out;
  FILE* f = fopen(path, "rb");
  if (!f) {
    out.error = "cannot open file";
    return out;
  }
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf((size_t)size);
  if (fread(buf.data(), 1, (size_t)size, f) != (size_t)size) {
    fclose(f);
    out.error = "short read";
    return out;
  }
  fclose(f);
  if (size < 44 || memcmp(buf.data(), "RIFF", 4) != 0 ||
      memcmp(buf.data() + 8, "WAVE", 4) != 0) {
    out.error = "not a RIFF/WAVE file";
    return out;
  }
  size_t pos = 12;
  int fmt_code = 0, n_ch = 0, bits = 0, sr = 0;
  const uint8_t* data = nullptr;
  size_t data_len = 0;
  while (pos + 8 <= (size_t)size) {
    const uint8_t* hdr = buf.data() + pos;
    uint32_t csize = rd_u32(hdr + 4);
    const uint8_t* payload = hdr + 8;
    if (pos + 8 + csize > (size_t)size) csize = (uint32_t)((size_t)size - pos - 8);
    if (memcmp(hdr, "fmt ", 4) == 0 && csize >= 16) {
      fmt_code = rd_u16(payload);
      n_ch = rd_u16(payload + 2);
      sr = (int)rd_u32(payload + 4);
      bits = rd_u16(payload + 14);
      if (fmt_code == 0xFFFE && csize >= 40) fmt_code = rd_u16(payload + 24);
    } else if (memcmp(hdr, "data", 4) == 0) {
      data = payload;
      data_len = csize;
    }
    pos += 8 + csize + (csize & 1);
  }
  if (!data || n_ch <= 0 || sr <= 0) {
    out.error = "missing fmt/data chunk";
    return out;
  }
  // Validate bits BEFORE computing frame geometry: a malformed fmt chunk
  // with bits=0 would SIGFPE on the division below, killing the loader
  // worker (and with it the corpus driver's per-file error isolation).
  if (bits != 8 && bits != 16 && bits != 24 && bits != 32 && bits != 64) {
    out.error = "unsupported WAV format";
    return out;
  }
  size_t bytes_per = (size_t)bits / 8;
  size_t n_frames = data_len / (bytes_per * (size_t)n_ch);
  out.sample_rate = sr;
  // first channel only (analysis is mono; matches reference channelN=0)
  if (want_i16 && fmt_code == 1 && bits == 16) {
    out.samples_i16.resize(n_frames);
    if (n_ch == 1) {
      memcpy(out.samples_i16.data(), data, n_frames * 2);
    } else {
      for (size_t i = 0; i < n_frames; i++)
        memcpy(&out.samples_i16[i], data + i * 2 * n_ch, 2);
    }
    return out;
  }
  out.samples.resize(n_frames);
  if (fmt_code == 1 && bits == 16) {
    for (size_t i = 0; i < n_frames; i++) {
      int16_t v;
      memcpy(&v, data + i * 2 * n_ch, 2);
      out.samples[i] = (float)v / 32768.0f;
    }
  } else if (fmt_code == 1 && bits == 32) {
    for (size_t i = 0; i < n_frames; i++) {
      int32_t v;
      memcpy(&v, data + i * 4 * n_ch, 4);
      out.samples[i] = (float)((double)v / 2147483648.0);
    }
  } else if (fmt_code == 1 && bits == 24) {
    for (size_t i = 0; i < n_frames; i++) {
      const uint8_t* p = data + i * 3 * n_ch;
      int32_t v = (int32_t)(p[0] | (p[1] << 8) | (p[2] << 16));
      v = (v ^ 0x800000) - 0x800000;
      out.samples[i] = (float)v / 8388608.0f;
    }
  } else if (fmt_code == 1 && bits == 8) {
    for (size_t i = 0; i < n_frames; i++)
      out.samples[i] = ((float)data[i * n_ch] - 128.0f) / 128.0f;
  } else if (fmt_code == 3 && bits == 32) {
    for (size_t i = 0; i < n_frames; i++) {
      float v;
      memcpy(&v, data + i * 4 * n_ch, 4);
      out.samples[i] = v;
    }
  } else if (fmt_code == 3 && bits == 64) {
    for (size_t i = 0; i < n_frames; i++) {
      double v;
      memcpy(&v, data + i * 8 * n_ch, 8);
      out.samples[i] = (float)v;
    }
  } else {
    out.error = "unsupported WAV format";
  }
  return out;
}

// Polyphase resampling equivalent to scipy.signal.upfirdn + resample_poly
// trimming: x upsampled by L (zero-stuffed), filtered with h, decimated by M;
// output shifted by (len(h)-1)/2 and cut to ceil(n*L/M) samples.
std::vector<float> resample_poly(const std::vector<float>& x, int up, int down,
                                 const double* h, int n_taps) {
  if (up == down) return x;
  const long n_in = (long)x.size();
  const long n_out = (n_in * (long)up + down - 1) / down;
  const long half = ((long)n_taps - 1) / 2;
  std::vector<float> y((size_t)n_out);
  // y[m] corresponds to hi-rate index t = m*down + half of conv(xu, h):
  //   conv[t] = sum_k h[k] * xu[t-k],  xu[j] = x[j/up] when j%up==0
  for (long m = 0; m < n_out; m++) {
    const long t = m * (long)down + half;
    double acc = 0.0;
    // k must satisfy (t-k)%up==0 and 0<=(t-k)/up<n_in and 0<=k<n_taps
    long k0 = t % up;  // smallest k with (t-k)%up==0
    for (long k = k0; k < n_taps; k += up) {
      const long j = (t - k) / up;
      if (j < 0) break;         // j decreases as k grows: done
      if (j >= n_in) continue;  // beyond the end (small k): skip
      acc += h[k] * (double)x[(size_t)j];
    }
    y[(size_t)m] = (float)(acc * up);
  }
  return y;
}

struct Job {
  int index;
  std::string path;
};

struct Result {
  int index = -1;
  std::vector<float> samples;
  std::vector<int16_t> samples_i16;  // int16 passthrough (see Decoded)
  int sample_rate = 0;
  std::string error;
};

struct Loader {
  int target_sr;
  bool want_i16 = false;
  // ratio-specific polyphase taps: key = up * 1000000 + down
  std::map<long, std::vector<double>> taps_table;
  std::mutex mu;
  std::condition_variable cv_jobs, cv_results;
  std::queue<Job> jobs;
  std::queue<Result> results;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::atomic<int> pending{0};
};

void worker_loop(Loader* L) {
  while (true) {
    Job job;
    {
      std::unique_lock<std::mutex> lk(L->mu);
      L->cv_jobs.wait(lk, [&] { return L->stop || !L->jobs.empty(); });
      if (L->stop && L->jobs.empty()) return;
      job = L->jobs.front();
      L->jobs.pop();
    }
    Result r;
    r.index = job.index;
    Decoded d = decode_wav(job.path.c_str(), L->want_i16);
    if (!d.error.empty()) {
      r.error = d.error;
    } else {
      r.sample_rate = L->target_sr;
      if (!d.samples_i16.empty() && d.sample_rate != L->target_sr) {
        // passthrough requested but this file needs resampling: convert
        // to float here (the resampler is float-domain)
        d.samples.resize(d.samples_i16.size());
        for (size_t i = 0; i < d.samples_i16.size(); i++)
          d.samples[i] = (float)d.samples_i16[i] / 32768.0f;
        d.samples_i16.clear();
      }
      if (!d.samples_i16.empty()) {
        r.samples_i16 = std::move(d.samples_i16);
      } else if (d.sample_rate == L->target_sr) {
        r.samples = std::move(d.samples);
      } else {
        // reduce ratio
        int a = d.sample_rate, b = L->target_sr;
        while (b) { int t = a % b; a = b; b = t; }
        int up = L->target_sr / a, down = d.sample_rate / a;
        const std::vector<double>* taps = nullptr;
        {
          std::lock_guard<std::mutex> lk(L->mu);
          auto it = L->taps_table.find((long)up * 1000000 + down);
          if (it != L->taps_table.end()) taps = &it->second;
        }
        if (!taps) {
          r.error = "no resampler taps for ratio";
        } else {
          r.samples = resample_poly(d.samples, up, down, taps->data(),
                                    (int)taps->size());
        }
      }
    }
    {
      std::lock_guard<std::mutex> lk(L->mu);
      L->results.push(std::move(r));
    }
    L->cv_results.notify_one();
  }
}

}  // namespace

extern "C" {

// ---- one-shot API ---------------------------------------------------------

// Decode a WAV to float32 (first channel). Returns sample count or -1.
// Caller frees with modmfcc_free. *err_out gets a static error string.
long modmfcc_decode_wav(const char* path, float** data_out, int* sr_out) {
  Decoded d = decode_wav(path);
  if (!d.error.empty()) return -1;
  float* mem = (float*)malloc(d.samples.size() * sizeof(float));
  memcpy(mem, d.samples.data(), d.samples.size() * sizeof(float));
  *data_out = mem;
  *sr_out = d.sample_rate;
  return (long)d.samples.size();
}

long modmfcc_resample(const float* x, long n, int up, int down,
                      const double* taps, int n_taps, float** out) {
  std::vector<float> xin(x, x + n);
  std::vector<float> y = resample_poly(xin, up, down, taps, n_taps);
  float* mem = (float*)malloc(y.size() * sizeof(float));
  memcpy(mem, y.data(), y.size() * sizeof(float));
  *out = mem;
  return (long)y.size();
}

void modmfcc_free(void* p) { free(p); }

// ---- threaded batch loader ------------------------------------------------

void* modmfcc_loader_create(int n_threads, int target_sr) {
  Loader* L = new Loader();
  L->target_sr = target_sr;
  if (n_threads < 1) n_threads = 1;
  for (int i = 0; i < n_threads; i++)
    L->workers.emplace_back(worker_loop, L);
  return (void*)L;
}

// As modmfcc_loader_create, plus int16 passthrough: 16-bit PCM files that
// need no resampling come back as raw int16 (drain with
// modmfcc_loader_next2) — the corpus upload format, skipping the
// float32 conversion and the Python-side on-grid re-check entirely.
void* modmfcc_loader_create2(int n_threads, int target_sr, int want_i16) {
  Loader* L = (Loader*)modmfcc_loader_create(n_threads, target_sr);
  L->want_i16 = (want_i16 != 0);
  return (void*)L;
}

// Register polyphase taps for one (up, down) ratio (design done in Python).
void modmfcc_loader_add_taps(void* handle, int up, int down,
                             const double* taps, int n_taps) {
  Loader* L = (Loader*)handle;
  std::lock_guard<std::mutex> lk(L->mu);
  L->taps_table[(long)up * 1000000 + down].assign(taps, taps + n_taps);
}

void modmfcc_loader_submit(void* handle, int index, const char* path) {
  Loader* L = (Loader*)handle;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->jobs.push(Job{index, std::string(path)});
    L->pending++;
  }
  L->cv_jobs.notify_one();
}

int modmfcc_loader_next2(void* handle, void** data, long* n, int* is_i16);

// Blocks for the next finished file. Returns its index, or -1 if nothing
// pending. On success *data/*n carry the samples (caller must modmfcc_free);
// when the file failed, *n == -1 and *data is NULL (error consumed the job).
int modmfcc_loader_next(void* handle, float** data, long* n) {
  int is_i16 = 0;
  int idx = modmfcc_loader_next2(handle, (void**)data, n, &is_i16);
  if (idx >= 0 && *n >= 0 && is_i16) {
    // caller used the legacy float API on an i16-passthrough loader:
    // convert (allocation swap keeps the free contract)
    int16_t* src = (int16_t*)*data;
    float* mem = (float*)malloc((size_t)(*n) * sizeof(float));
    for (long i = 0; i < *n; i++) mem[i] = (float)src[i] / 32768.0f;
    free(src);
    *data = mem;
  }
  return idx;
}

// Blocks for the next finished file. Same contract as modmfcc_loader_next,
// but *is_i16 reports the payload format: 1 = int16 passthrough (cast
// *data to int16_t*), 0 = float32.
int modmfcc_loader_next2(void* handle, void** data, long* n, int* is_i16) {
  Loader* L = (Loader*)handle;
  std::unique_lock<std::mutex> lk(L->mu);
  *is_i16 = 0;
  if (L->pending.load() == 0 && L->results.empty()) return -1;
  L->cv_results.wait(lk, [&] { return !L->results.empty(); });
  Result r = std::move(L->results.front());
  L->results.pop();
  L->pending--;
  if (!r.error.empty()) {
    *data = nullptr;
    *n = -1;
    return r.index;
  }
  if (!r.samples_i16.empty()) {
    int16_t* mem = (int16_t*)malloc(r.samples_i16.size() * sizeof(int16_t));
    memcpy(mem, r.samples_i16.data(), r.samples_i16.size() * sizeof(int16_t));
    *data = mem;
    *n = (long)r.samples_i16.size();
    *is_i16 = 1;
    return r.index;
  }
  float* mem = (float*)malloc(r.samples.size() * sizeof(float));
  memcpy(mem, r.samples.data(), r.samples.size() * sizeof(float));
  *data = mem;
  *n = (long)r.samples.size();
  return r.index;
}

void modmfcc_loader_destroy(void* handle) {
  Loader* L = (Loader*)handle;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
  }
  L->cv_jobs.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"

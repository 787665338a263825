// Native mel-spectrogram core of the autovc_tpu_torch host mels: a copy of
// autovc_tpu/native/melspec.cc, so the port builds and loads its own.
//
// A multithreaded C++ STFT+mel with librosa semantics (centre/reflect
// padding, periodic Hann, |STFT|^power, filterbank projection), driven
// from Python via ctypes (autovc_tpu_torch/native/__init__.py).
//
// FFT: iterative radix-2 Cooley-Tukey when n_fft is a power of two (the
// auto-encoder path, 2048); direct real DFT otherwise (the speaker-encoder
// path, 400 — 80 k MACs/frame, still cheap).  Parity with the numpy
// reference is tested at rtol 1e-3 (tests/test_torch_native.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

bool is_pow2(int n) { return n > 0 && (n & (n - 1)) == 0; }

// In-place iterative radix-2 complex FFT (re/im interleaved planes).
void fft_pow2(double* re, double* im, int n) {
  // bit reversal
  for (int i = 1, j = 0; i < n; ++i) {
    int bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) {
      std::swap(re[i], re[j]);
      std::swap(im[i], im[j]);
    }
  }
  for (int len = 2; len <= n; len <<= 1) {
    double ang = -2.0 * kPi / len;
    double wr = std::cos(ang), wi = std::sin(ang);
    for (int i = 0; i < n; i += len) {
      double cr = 1.0, ci = 0.0;
      for (int k = 0; k < len / 2; ++k) {
        int a = i + k, b = i + k + len / 2;
        double ur = re[a], ui = im[a];
        double vr = re[b] * cr - im[b] * ci;
        double vi = re[b] * ci + im[b] * cr;
        re[a] = ur + vr;
        im[a] = ui + vi;
        re[b] = ur - vr;
        im[b] = ui - vi;
        double ncr = cr * wr - ci * wi;
        ci = cr * wi + ci * wr;
        cr = ncr;
      }
    }
  }
}

struct DftTables {
  std::vector<double> cos_t, sin_t;  // (n_bins, n_fft)
};

void spectrogram_rows(const float* padded, int64_t padded_len, int n_fft,
                      int hop, const double* window, int n_bins,
                      int n_frames, int power, const float* mel_fb,
                      int n_mels, float* out, int row_begin, int row_end,
                      const DftTables* dft) {
  std::vector<double> re(n_fft), im(n_fft), mag(n_bins);
  for (int t = row_begin; t < row_end; ++t) {
    const float* frame = padded + int64_t(t) * hop;
    if (dft == nullptr) {
      for (int i = 0; i < n_fft; ++i) {
        re[i] = double(frame[i]) * window[i];
        im[i] = 0.0;
      }
      fft_pow2(re.data(), im.data(), n_fft);
      for (int k = 0; k < n_bins; ++k) {
        double m2 = re[k] * re[k] + im[k] * im[k];
        mag[k] = power == 2 ? m2 : std::sqrt(m2);
      }
    } else {
      // direct real DFT against precomputed windowed tables
      for (int k = 0; k < n_bins; ++k) {
        double sr = 0.0, si = 0.0;
        const double* ct = dft->cos_t.data() + int64_t(k) * n_fft;
        const double* st = dft->sin_t.data() + int64_t(k) * n_fft;
        for (int i = 0; i < n_fft; ++i) {
          double v = double(frame[i]);
          sr += v * ct[i];
          si += v * st[i];
        }
        double m2 = sr * sr + si * si;
        mag[k] = power == 2 ? m2 : std::sqrt(m2);
      }
    }
    // mel projection: out[t, m] = sum_k fb[m, k] * mag[k]
    float* row = out + int64_t(t) * n_mels;
    for (int m = 0; m < n_mels; ++m) {
      const float* fb = mel_fb + int64_t(m) * n_bins;
      double acc = 0.0;
      for (int k = 0; k < n_bins; ++k) acc += double(fb[k]) * mag[k];
      row[m] = float(acc);
    }
  }
}

}  // namespace

extern "C" {

// Computes a mel spectrogram with librosa semantics.
//   wav: n samples float32; out: (n_frames, n_mels) float32, row-major,
//   n_frames = 1 + (n + 2*(n_fft/2) - n_fft) / hop  (center=true).
// Returns the number of frames written, or -1 on error.
int64_t autovc_mel_spectrogram(const float* wav, int64_t n, int n_fft,
                               int hop, int win_length, int power,
                               const float* mel_fb, int n_mels,
                               float* out, int n_threads) {
  if (n_fft <= 0 || hop <= 0 || win_length > n_fft) return -1;
  const int pad = n_fft / 2;
  const int64_t padded_len = n + 2 * pad;
  if (padded_len < n_fft) return -1;

  // centre/reflect pad
  std::vector<float> padded(padded_len);
  for (int64_t i = 0; i < padded_len; ++i) {
    int64_t j = i - pad;
    if (j < 0) j = -j;                       // reflect head
    if (j >= n) j = 2 * (n - 1) - j;         // reflect tail
    if (j < 0) j = 0;                        // degenerate tiny inputs
    padded[i] = wav[j];
  }

  // periodic Hann, centre-padded to n_fft
  std::vector<double> window(n_fft, 0.0);
  const int lpad = (n_fft - win_length) / 2;
  for (int i = 0; i < win_length; ++i)
    window[lpad + i] = 0.5 - 0.5 * std::cos(2.0 * kPi * i / win_length);

  const int n_bins = 1 + n_fft / 2;
  const int n_frames = int(1 + (padded_len - n_fft) / hop);

  DftTables tables;
  DftTables* dft = nullptr;
  if (!is_pow2(n_fft)) {
    tables.cos_t.resize(int64_t(n_bins) * n_fft);
    tables.sin_t.resize(int64_t(n_bins) * n_fft);
    for (int k = 0; k < n_bins; ++k)
      for (int i = 0; i < n_fft; ++i) {
        double ang = 2.0 * kPi * k * i / n_fft;
        tables.cos_t[int64_t(k) * n_fft + i] = std::cos(ang) * window[i];
        tables.sin_t[int64_t(k) * n_fft + i] = -std::sin(ang) * window[i];
      }
    dft = &tables;
  }

  if (n_threads <= 0)
    n_threads = int(std::thread::hardware_concurrency());
  n_threads = std::max(1, std::min(n_threads, n_frames));
  std::vector<std::thread> workers;
  const int per = (n_frames + n_threads - 1) / n_threads;
  for (int w = 0; w < n_threads; ++w) {
    int begin = w * per, end = std::min(n_frames, begin + per);
    if (begin >= end) break;
    workers.emplace_back(spectrogram_rows, padded.data(), padded_len, n_fft,
                         hop, window.data(), n_bins, n_frames, power, mel_fb,
                         n_mels, out, begin, end, dft);
  }
  for (auto& t : workers) t.join();
  return n_frames;
}

// dB + [0,1] normalisation epilogue for the auto-encoder path
// (spectrogram.py:54-56, 14-32): 20*log10(max(1e-5, x)) -> (db+100)/100.
void autovc_amp_to_db_normalize(float* data, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    float a = data[i] < 1e-5f ? 1e-5f : data[i];
    float db = 20.0f * std::log10(a);
    float v = (db + 100.0f) / 100.0f;
    data[i] = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
  }
}

}  // extern "C"

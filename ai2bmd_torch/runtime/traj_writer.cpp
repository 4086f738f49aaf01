// Asynchronous trajectory writer (the port's native runtime).
//
// The port's copy of ai2bmd_tpu/runtime/traj_writer.cpp: frames are copied
// into a queue on submit and written to disk (CHARMM DCD and/or extended
// XYZ) by a worker thread, so the MD loop never waits on file IO.  The
// bytes are those of the JAX package's native writer and of the port's
// Python writers (ai2bmd_torch/io/trajectory.py), except the DCD title,
// which names this writer.
//
// C ABI (used from Python via ctypes, ai2bmd_torch/runtime/__init__.py):
//   void* traj_open(const char* dcd_path, const char* xyz_path,
//                   int n_atoms, double timestep_fs, int save_interval,
//                   const char* symbols /* space-separated, for xyz */,
//                   const double* cell /* 3 orthorhombic box lengths, or
//                                         NULL for no unit-cell records */);
//   int   traj_write(void* h, const float* xyz, double energy, long step);
//                                // 0; -1 once closing; -2 once a write of
//                                // an earlier frame failed
//   long  traj_pending(void* h);
//   int   traj_close(void* h);   // drains the queue, patches the header;
//                                // 0, or -1 if any write or close failed
//
// Unlike the JAX package's, the writer reports IO failures (a short fwrite
// or fprintf in the worker, a failed fseek, fflush or fclose): traj_write
// refuses the next frame once the worker has failed, and traj_close returns
// -1, so the caller can raise as the Python writers do.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 -o libtraj.so traj_writer.cpp -lpthread

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  std::vector<float> xyz;
  double energy;
  long step;
};

struct DcdFile {
  FILE* f = nullptr;
  int n_atoms = 0;
  int n_frames = 0;
  bool has_cell = false;
  bool failed = false;
  double cell[3] = {0, 0, 0};  // orthorhombic box lengths (Angstrom)

  void record(const void* payload, uint32_t n) {
    failed |= fwrite(&n, 4, 1, f) != 1;
    failed |= fwrite(payload, 1, n, f) != n;
    failed |= fwrite(&n, 4, 1, f) != 1;
  }

  bool open(const char* path, int natoms, double timestep_fs, int interval,
            const double* box) {
    f = fopen(path, "wb");
    if (!f) return false;
    n_atoms = natoms;
    if (box) {
      has_cell = true;
      for (int i = 0; i < 3; ++i) cell[i] = box[i];
    }
    // header: "CORD" + 20 int control block
    char hdr[4 + 20 * 4];
    memcpy(hdr, "CORD", 4);
    int32_t icntrl[20] = {0};
    icntrl[2] = interval;
    float delta = static_cast<float>(timestep_fs * interval / 48.88821);
    memcpy(&icntrl[9], &delta, 4);
    icntrl[10] = has_cell ? 1 : 0;  // CHARMM unit-cell-per-frame flag
    icntrl[19] = 24;
    memcpy(hdr + 4, icntrl, 80);
    record(hdr, sizeof(hdr));
    static const char kTitle[] = "Created by ai2bmd-torch native runtime";
    char title[4 + 80];
    int32_t one = 1;
    memcpy(title, &one, 4);
    memset(title + 4, ' ', 80);
    memcpy(title + 4, kTitle, sizeof(kTitle) - 1);
    record(title, sizeof(title));
    int32_t na = natoms;
    record(&na, 4);
    return true;
  }

  void write(const Frame& fr) {
    if (has_cell) {
      // CHARMM XTLABC: a, cos(gamma), b, cos(beta), cos(alpha), c
      double xtl[6] = {cell[0], 0.0, cell[1], 0.0, 0.0, cell[2]};
      record(xtl, sizeof(xtl));
    }
    std::vector<float> axis(n_atoms);
    for (int c = 0; c < 3; ++c) {
      for (int i = 0; i < n_atoms; ++i) axis[i] = fr.xyz[3 * i + c];
      record(axis.data(), n_atoms * 4);
    }
    ++n_frames;
  }

  void close() {
    if (!f) return;
    failed |= fflush(f) != 0;
    // patch frame counts at fixed offsets (marker + "CORD")
    int32_t nf = n_frames;
    failed |= fseek(f, 4 + 4, SEEK_SET) != 0;
    failed |= fwrite(&nf, 4, 1, f) != 1;
    failed |= fseek(f, 4 + 4 + 3 * 4, SEEK_SET) != 0;
    failed |= fwrite(&nf, 4, 1, f) != 1;
    failed |= fclose(f) != 0;
    f = nullptr;
  }
};

struct XyzFile {
  FILE* f = nullptr;
  bool failed = false;
  std::vector<std::string> symbols;

  bool open(const char* path, const char* syms) {
    f = fopen(path, "w");
    if (!f) return false;
    std::istringstream ss(syms);
    std::string tok;
    while (ss >> tok) symbols.push_back(tok);
    return true;
  }

  void write(const Frame& fr) {
    failed |= fprintf(f, "%zu\nstep=%ld energy_eV=%.6f\n", symbols.size(), fr.step,
                      fr.energy) < 0;
    for (size_t i = 0; i < symbols.size(); ++i) {
      failed |= fprintf(f, "%s %.6f %.6f %.6f\n", symbols[i].c_str(), fr.xyz[3 * i],
                        fr.xyz[3 * i + 1], fr.xyz[3 * i + 2]) < 0;
    }
  }

  void close() {
    if (f) failed |= fclose(f) != 0;
    f = nullptr;
  }
};

struct Writer {
  DcdFile dcd;
  XyzFile xyz;
  bool has_dcd = false, has_xyz = false;
  int n_atoms = 0;

  std::deque<Frame> queue;
  std::mutex mu;
  std::condition_variable cv;
  bool closing = false;
  std::atomic<bool> failed{false};  // set by the worker after a failed write
  std::thread worker;

  void run() {
    for (;;) {
      Frame fr;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return closing || !queue.empty(); });
        if (queue.empty()) {
          if (closing) return;
          continue;
        }
        fr = std::move(queue.front());
        queue.pop_front();
      }
      if (has_dcd) dcd.write(fr);
      if (has_xyz) xyz.write(fr);
      if (dcd.failed || xyz.failed) failed = true;
      cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* traj_open(const char* dcd_path, const char* xyz_path, int n_atoms,
                double timestep_fs, int save_interval, const char* symbols,
                const double* cell /* 3 box lengths or NULL */) {
  auto* w = new Writer();
  w->n_atoms = n_atoms;
  if (dcd_path && dcd_path[0]) {
    if (!w->dcd.open(dcd_path, n_atoms, timestep_fs, save_interval, cell)) {
      delete w;
      return nullptr;
    }
    w->has_dcd = true;
  }
  if (xyz_path && xyz_path[0]) {
    if (!w->xyz.open(xyz_path, symbols ? symbols : "")) {
      if (w->has_dcd) w->dcd.close();
      delete w;
      return nullptr;
    }
    w->has_xyz = true;
  }
  w->worker = std::thread([w] { w->run(); });
  return w;
}

int traj_write(void* h, const float* xyz, double energy, long step) {
  auto* w = static_cast<Writer*>(h);
  if (w->failed) return -2;
  Frame fr;
  fr.xyz.assign(xyz, xyz + 3 * w->n_atoms);
  fr.energy = energy;
  fr.step = step;
  {
    std::lock_guard<std::mutex> lk(w->mu);
    if (w->closing) return -1;
    w->queue.push_back(std::move(fr));
  }
  w->cv.notify_all();
  return 0;
}

long traj_pending(void* h) {
  auto* w = static_cast<Writer*>(h);
  std::lock_guard<std::mutex> lk(w->mu);
  return static_cast<long>(w->queue.size());
}

int traj_close(void* h) {
  auto* w = static_cast<Writer*>(h);
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->closing = true;
  }
  w->cv.notify_all();
  w->worker.join();
  if (w->has_dcd) w->dcd.close();
  if (w->has_xyz) w->xyz.close();
  const bool failed = w->dcd.failed || w->xyz.failed;
  delete w;
  return failed ? -1 : 0;
}

}  // extern "C"

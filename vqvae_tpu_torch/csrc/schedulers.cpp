// Native step schedulers: Linear / Cosine / LinearCosine step objects with
// explicit create/step/destroy lifetime, exposed through a C ABI for ctypes.
// A copy of the JAX package's csrc/schedulers.cpp (the C++ equivalent of
// the reference's `scheduling_utils.schedulers_cpp`, reference
// vqvae/model.py:6, 163-230), kept here so that the PyTorch port builds it
// without the JAX package.
//
// The train step takes its LR from the Python schedules of
// vqvae_tpu_torch/train/schedules.py (same math); this library is the
// host-side runtime of record for the logged LR
// (vqvae_tpu_torch/train/native_schedulers.py loads it).
//
// Build: vqvae_tpu_torch/ops/_build.py (g++, at first use).

#include <cmath>
#include <cstdint>

namespace {

constexpr double kPi = 3.14159265358979323846;

enum class Kind : int32_t { kLinear = 0, kCosine = 1, kLinearCosine = 2 };

struct Scheduler {
  Kind kind;
  double start_step;
  double stop_step;
  double v0;      // linear/cosine: start value; linear_cosine: peak value
  double v1;      // end value
  double warmup_end;  // linear_cosine only
};

double clamp01(double t) { return t < 0.0 ? 0.0 : (t > 1.0 ? 1.0 : t); }

double linear_at(double step, double start, double stop, double v0, double v1) {
  double denom = stop - start;
  if (denom <= 0.0) denom = 1e-9;
  double t = clamp01((step - start) / denom);
  return v0 + (v1 - v0) * t;
}

double cosine_at(double step, double start, double stop, double v0, double v1) {
  double denom = stop - start;
  if (denom <= 0.0) denom = 1e-9;
  double t = clamp01((step - start) / denom);
  return v1 + (v0 - v1) * 0.5 * (1.0 + std::cos(kPi * t));
}

}  // namespace

extern "C" {

void* scheduler_create_linear(double start_step, double stop_step,
                              double v0, double v1) {
  return new Scheduler{Kind::kLinear, start_step, stop_step, v0, v1, 0.0};
}

void* scheduler_create_cosine(double start_step, double stop_step,
                              double v0, double v1) {
  return new Scheduler{Kind::kCosine, start_step, stop_step, v0, v1, 0.0};
}

void* scheduler_create_linear_cosine(double start_step, double stop_step,
                                     double v_peak, double v_end,
                                     double warmup_end) {
  return new Scheduler{Kind::kLinearCosine, start_step, stop_step,
                       v_peak, v_end, warmup_end};
}

double scheduler_step(void* handle, double step) {
  const Scheduler* s = static_cast<Scheduler*>(handle);
  switch (s->kind) {
    case Kind::kLinear:
      return linear_at(step, s->start_step, s->stop_step, s->v0, s->v1);
    case Kind::kCosine:
      return cosine_at(step, s->start_step, s->stop_step, s->v0, s->v1);
    case Kind::kLinearCosine:
      if (step < s->warmup_end) {
        return linear_at(step, s->start_step, s->warmup_end, 0.0, s->v0);
      }
      return cosine_at(step, s->warmup_end, s->stop_step, s->v0, s->v1);
  }
  return 0.0;
}

// Batched evaluation: fills out[i] = value at steps[i]. Lets the host compute
// a whole epoch of LR values in one call.
void scheduler_step_many(void* handle, const double* steps, double* out,
                         int64_t n) {
  for (int64_t i = 0; i < n; ++i) out[i] = scheduler_step(handle, steps[i]);
}

void scheduler_destroy(void* handle) {
  delete static_cast<Scheduler*>(handle);
}

}  // extern "C"

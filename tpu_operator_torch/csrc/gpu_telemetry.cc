// gpu-telemetry: per-card telemetry scraper over NVML, the native half
// of the port's chip exporter (the slot DCGM's host engine fills in the
// NVIDIA operator).
//
// Counterpart of native/tpu_telemetry.cc, which reads the TPU VM
// kernel's accel sysfs counters. This one reads NVML, opened with
// dlopen so that building it needs no NVIDIA header or library:
// $GPU_TELEMETRY_NVML or --nvml PATH names the library (default
// libnvidia-ml.so.1; tests point it at a fake). It emits one JSON array
// on stdout, one object per card, in the reference's contract:
//   [{"chip_id": "gpu0", "duty_cycle_pct": N, "hbm_used_bytes": N,
//     "hbm_total_bytes": N, "hbm_usage_known": true|false,
//     "tensorcore_util_pct": N, "temperature_c": N|null}, ...]
//
// - duty_cycle_pct is nvmlDeviceGetUtilizationRates' gpu share: the
//   share of the last sample period in which a kernel ran.
// - tensorcore_util_pct is 0: NVML has no tensor-core activity (that is
//   a DCGM profiling field), as the reference's JAX collector reports 0.
// - A query NVML refuses (NOT_SUPPORTED, as a virtualised card may) is
//   reported as the reference reports a missing counter: temperature_c
//   null, or the used bytes 0 with hbm_usage_known false; nothing is
//   invented. Each refusal is named on stderr with NVML's code.
//
// Exit code: 0 when at least one card is seen, 1 otherwise, including
// when NVML cannot be opened or initialised.
//
// --watch N runs as a long-lived engine: one JSON array per line every N
// seconds, flushed, until the supervisor terminates it. An empty tick
// (NVML not there yet, no card) prints [] and keeps running, and the
// next tick tries NVML again.
//
// --inventory prints the host's cards and driver once, as one object:
//   {"driver_version": "580.x",
//    "cards": [{"chip_id": "gpu0", "index": 0, "uuid": "GPU-...",
//               "minor": 4, "name": "NVIDIA H100 80GB HBM3",
//               "memory_total_bytes": N}, ...]}
// The device plugin names a card gpu<index> and matches it by UUID; the
// minor number names its /dev/nvidia<minor> node (index 0 may well be
// /dev/nvidia4). A query NVML refuses gives null (uuid, minor, name) and
// a line on stderr; exit code 1 when NVML cannot be opened or lacks the
// inventory's entry points.
//
// Build: tpu_operator_torch.kernels.build.build_host("gpu_telemetry")
// (the host C++ compiler, -ldl; into build/kernels/ at first use).

#include <dlfcn.h>
#include <unistd.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

namespace {

// NVML's ABI, as nvml.h declares it
typedef int nvmlReturn_t;
typedef struct nvmlDevice_st* nvmlDevice_t;
struct nvmlMemory_t {
  unsigned long long total;
  unsigned long long free;
  unsigned long long used;
};
struct nvmlUtilization_t {
  unsigned int gpu;
  unsigned int memory;
};
constexpr nvmlReturn_t NVML_SUCCESS = 0;
constexpr int NVML_TEMPERATURE_GPU = 0;

struct Nvml {
  void* lib = nullptr;
  bool ready = false;
  nvmlReturn_t (*init)() = nullptr;
  nvmlReturn_t (*count)(unsigned int*) = nullptr;
  nvmlReturn_t (*handle)(unsigned int, nvmlDevice_t*) = nullptr;
  nvmlReturn_t (*memory)(nvmlDevice_t, nvmlMemory_t*) = nullptr;
  nvmlReturn_t (*utilization)(nvmlDevice_t, nvmlUtilization_t*) = nullptr;
  nvmlReturn_t (*temperature)(nvmlDevice_t, int, unsigned int*) = nullptr;
  const char* (*error_string)(nvmlReturn_t) = nullptr;  // optional
  // the inventory's entry points, resolved when present
  nvmlReturn_t (*driver_version)(char*, unsigned int) = nullptr;
  nvmlReturn_t (*uuid)(nvmlDevice_t, char*, unsigned int) = nullptr;
  nvmlReturn_t (*minor)(nvmlDevice_t, unsigned int*) = nullptr;
  nvmlReturn_t (*name)(nvmlDevice_t, char*, unsigned int) = nullptr;
};

template <typename F>
bool Sym(void* lib, const char* name, F* out) {
  *out = reinterpret_cast<F>(dlsym(lib, name));
  return *out != nullptr;
}

// opens and initialises NVML once; false (and a line on stderr) when the
// library or a required symbol is missing or nvmlInit_v2 fails
bool Open(Nvml* n, const std::string& path) {
  if (n->ready) return true;
  if (n->lib == nullptr) {
    n->lib = dlopen(path.c_str(), RTLD_NOW | RTLD_LOCAL);
    if (n->lib == nullptr) {
      fprintf(stderr, "gpu-telemetry: cannot open %s: %s\n", path.c_str(),
              dlerror());
      return false;
    }
    Sym(n->lib, "nvmlErrorString", &n->error_string);
    Sym(n->lib, "nvmlSystemGetDriverVersion", &n->driver_version);
    Sym(n->lib, "nvmlDeviceGetUUID", &n->uuid);
    Sym(n->lib, "nvmlDeviceGetMinorNumber", &n->minor);
    Sym(n->lib, "nvmlDeviceGetName", &n->name);
    if (!Sym(n->lib, "nvmlInit_v2", &n->init) ||
        !Sym(n->lib, "nvmlDeviceGetCount_v2", &n->count) ||
        !Sym(n->lib, "nvmlDeviceGetHandleByIndex_v2", &n->handle) ||
        !Sym(n->lib, "nvmlDeviceGetMemoryInfo", &n->memory) ||
        !Sym(n->lib, "nvmlDeviceGetUtilizationRates", &n->utilization) ||
        !Sym(n->lib, "nvmlDeviceGetTemperature", &n->temperature)) {
      fprintf(stderr, "gpu-telemetry: %s lacks an NVML entry point\n",
              path.c_str());
      dlclose(n->lib);
      n->lib = nullptr;
      return false;
    }
  }
  nvmlReturn_t rc = n->init();
  if (rc != NVML_SUCCESS) {
    fprintf(stderr, "gpu-telemetry: nvmlInit_v2: %s (%d)\n",
            n->error_string ? n->error_string(rc) : "error", rc);
    return false;
  }
  n->ready = true;
  return true;
}

void Refused(const Nvml& n, unsigned int i, const char* what,
             nvmlReturn_t rc) {
  fprintf(stderr, "gpu-telemetry: gpu%u: %s: %s (%d)\n", i, what,
          n.error_string ? n.error_string(rc) : "error", rc);
}

}  // namespace

// one scan of the cards, printed as a JSON array on one line; returns
// the number of cards seen
unsigned int ScanOnce(Nvml* n, const std::string& path) {
  unsigned int cards = 0;
  if (Open(n, path)) {
    nvmlReturn_t rc = n->count(&cards);
    if (rc != NVML_SUCCESS) {
      fprintf(stderr, "gpu-telemetry: nvmlDeviceGetCount_v2: %s (%d)\n",
              n->error_string ? n->error_string(rc) : "error", rc);
      cards = 0;
    }
  }
  printf("[");
  unsigned int seen = 0;
  for (unsigned int i = 0; i < cards; ++i) {
    nvmlDevice_t dev = nullptr;
    nvmlReturn_t rc = n->handle(i, &dev);
    if (rc != NVML_SUCCESS) {
      Refused(*n, i, "nvmlDeviceGetHandleByIndex_v2", rc);
      continue;
    }
    nvmlMemory_t mem = {0, 0, 0};
    bool mem_known = true;
    if ((rc = n->memory(dev, &mem)) != NVML_SUCCESS) {
      Refused(*n, i, "nvmlDeviceGetMemoryInfo", rc);
      mem = {0, 0, 0};
      mem_known = false;
    }
    nvmlUtilization_t util = {0, 0};
    if ((rc = n->utilization(dev, &util)) != NVML_SUCCESS) {
      Refused(*n, i, "nvmlDeviceGetUtilizationRates", rc);
      util = {0, 0};
    }
    unsigned int temp = 0;
    bool temp_known = true;
    if ((rc = n->temperature(dev, NVML_TEMPERATURE_GPU, &temp)) !=
        NVML_SUCCESS) {
      Refused(*n, i, "nvmlDeviceGetTemperature", rc);
      temp_known = false;
    }
    if (seen++ > 0) printf(", ");
    printf("{\"chip_id\": \"gpu%u\", \"duty_cycle_pct\": %u, "
           "\"hbm_used_bytes\": %llu, \"hbm_total_bytes\": %llu, "
           "\"hbm_usage_known\": %s, \"tensorcore_util_pct\": 0, ",
           i, util.gpu, mem.used, mem.total, mem_known ? "true" : "false");
    if (temp_known) {
      printf("\"temperature_c\": %.3f}", static_cast<double>(temp));
    } else {
      printf("\"temperature_c\": null}");
    }
  }
  printf("]\n");
  fflush(stdout);
  return seen;
}

// a JSON string literal of s, or null when the query was refused
void PrintString(const char* s, bool known) {
  if (!known) {
    printf("null");
    return;
  }
  putchar('"');
  for (const char* c = s; *c; ++c) {
    if (*c == '"' || *c == '\\') putchar('\\');
    if (static_cast<unsigned char>(*c) >= 0x20) putchar(*c);
  }
  putchar('"');
}

// the --inventory object; returns the process's exit code
int Inventory(Nvml* n, const std::string& path) {
  if (!Open(n, path)) return 1;
  if (!n->driver_version || !n->uuid || !n->minor || !n->name) {
    fprintf(stderr, "gpu-telemetry: %s lacks an inventory entry point\n",
            path.c_str());
    return 1;
  }
  unsigned int cards = 0;
  nvmlReturn_t rc = n->count(&cards);
  if (rc != NVML_SUCCESS) {
    fprintf(stderr, "gpu-telemetry: nvmlDeviceGetCount_v2: %s (%d)\n",
            n->error_string ? n->error_string(rc) : "error", rc);
    return 1;
  }
  char buf[256] = {0};
  rc = n->driver_version(buf, sizeof(buf));
  if (rc != NVML_SUCCESS) {
    fprintf(stderr, "gpu-telemetry: nvmlSystemGetDriverVersion: %s (%d)\n",
            n->error_string ? n->error_string(rc) : "error", rc);
  }
  printf("{\"driver_version\": ");
  PrintString(buf, rc == NVML_SUCCESS);
  printf(", \"cards\": [");
  unsigned int seen = 0;
  for (unsigned int i = 0; i < cards; ++i) {
    nvmlDevice_t dev = nullptr;
    if ((rc = n->handle(i, &dev)) != NVML_SUCCESS) {
      Refused(*n, i, "nvmlDeviceGetHandleByIndex_v2", rc);
      continue;
    }
    if (seen++ > 0) printf(", ");
    printf("{\"chip_id\": \"gpu%u\", \"index\": %u, \"uuid\": ", i, i);
    char text[256] = {0};
    rc = n->uuid(dev, text, sizeof(text));
    if (rc != NVML_SUCCESS) Refused(*n, i, "nvmlDeviceGetUUID", rc);
    PrintString(text, rc == NVML_SUCCESS);
    unsigned int minor = 0;
    rc = n->minor(dev, &minor);
    if (rc != NVML_SUCCESS) {
      Refused(*n, i, "nvmlDeviceGetMinorNumber", rc);
      printf(", \"minor\": null");
    } else {
      printf(", \"minor\": %u", minor);
    }
    printf(", \"name\": ");
    text[0] = 0;
    rc = n->name(dev, text, sizeof(text));
    if (rc != NVML_SUCCESS) Refused(*n, i, "nvmlDeviceGetName", rc);
    PrintString(text, rc == NVML_SUCCESS);
    nvmlMemory_t mem = {0, 0, 0};
    if ((rc = n->memory(dev, &mem)) != NVML_SUCCESS) {
      Refused(*n, i, "nvmlDeviceGetMemoryInfo", rc);
    }
    printf(", \"memory_total_bytes\": %llu}", mem.total);
  }
  printf("]}\n");
  fflush(stdout);
  return 0;
}

int main(int argc, char** argv) {
  std::string path = "libnvidia-ml.so.1";
  if (const char* env = getenv("GPU_TELEMETRY_NVML")) path = env;
  long watch_s = 0;
  bool inventory = false;
  for (int i = 1; i < argc; ++i) {
    if (strcmp(argv[i], "--inventory") == 0) inventory = true;
    if (strcmp(argv[i], "--nvml") == 0 && i + 1 < argc) path = argv[++i];
    if (strcmp(argv[i], "--watch") == 0 && i + 1 < argc) {
      watch_s = strtol(argv[++i], nullptr, 10);
    }
  }
  Nvml nvml;
  if (inventory) return Inventory(&nvml, path);
  if (watch_s <= 0) return ScanOnce(&nvml, path) == 0 ? 1 : 0;
  // engine mode: scan on a fixed cadence; the supervisor owns the
  // process's lifetime
  for (;;) {
    ScanOnce(&nvml, path);
    sleep(static_cast<unsigned>(watch_s));
  }
}

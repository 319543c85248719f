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
// Each card also carries its NVLink facts, read where the library has
// the entry point:
//   "nvlink": [{"link": 0, "remote": "nvswitch"}, ...]  the active links
//       (nvmlDeviceGetNvLinkState over links 0..17) and what each reaches
//       (nvmlDeviceGetNvLinkRemoteDeviceType: gpu, ibmnpu, nvswitch or
//       unknown; null where refused);
//   "nvlink_peers": ["gpu1", ...]  the cards NVML reports reachable over
//       NVLink (nvmlDeviceGetP2PStatus, the NVLink capability);
//   "fabric": {"cluster_uuid": "...", "clique_id": N, "state":
//       "not_supported"|"not_started"|"in_progress"|"completed",
//       "status": N}  the card's NVLink fabric registration
//       (nvmlDeviceGetGpuFabricInfoV), the counterpart of an ICI domain
//       that spans hosts;
//   "refused": {"<NVML call>": code}  the calls NVML refused, each with
//       its code (null where the library lacks the call); the field a
//       refused call feeds is null, never a guess. A link NVML calls
//       INVALID_ARGUMENT is a link the card does not have.
//
// Build: tpu_operator_torch.kernels.build.build_host("gpu_telemetry")
// (the host C++ compiler, -ldl; into build/kernels/ at first use).

#include <dlfcn.h>
#include <unistd.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <utility>
#include <vector>

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
constexpr nvmlReturn_t NVML_ERROR_INVALID_ARGUMENT = 2;
constexpr nvmlReturn_t NVML_ERROR_ARGUMENT_VERSION_MISMATCH = 25;
constexpr int NVML_TEMPERATURE_GPU = 0;
constexpr unsigned int NVML_NVLINK_MAX_LINKS = 18;
constexpr int NVML_FEATURE_ENABLED = 1;
constexpr int NVML_P2P_CAPS_INDEX_NVLINK = 2;
constexpr int NVML_P2P_STATUS_OK = 0;
// nvmlGpuFabricInfo_v2_t and _v3_t share this prefix; v3 appends a
// healthSummary byte (40 bytes in all, v2 36)
struct nvmlGpuFabricInfo_t {
  unsigned int version;
  unsigned char cluster_uuid[16];
  nvmlReturn_t status;
  unsigned int clique_id;
  unsigned char state;
  unsigned int health_mask;
  unsigned char health_summary;
};
constexpr unsigned int FabricInfoVersion(unsigned int size, unsigned int v) {
  return size | (v << 24);
}
constexpr unsigned int NVML_GPU_FABRIC_INFO_V3 = FabricInfoVersion(40, 3);
constexpr unsigned int NVML_GPU_FABRIC_INFO_V2 = FabricInfoVersion(36, 2);
const char* const FABRIC_STATES[] = {"not_supported", "not_started",
                                     "in_progress", "completed"};

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
  // NVLink facts, resolved when present
  nvmlReturn_t (*nvlink_state)(nvmlDevice_t, unsigned int, int*) = nullptr;
  nvmlReturn_t (*nvlink_remote)(nvmlDevice_t, unsigned int, int*) = nullptr;
  nvmlReturn_t (*p2p)(nvmlDevice_t, nvmlDevice_t, int, int*) = nullptr;
  nvmlReturn_t (*fabric)(nvmlDevice_t, nvmlGpuFabricInfo_t*) = nullptr;
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
    Sym(n->lib, "nvmlDeviceGetNvLinkState", &n->nvlink_state);
    Sym(n->lib, "nvmlDeviceGetNvLinkRemoteDeviceType", &n->nvlink_remote);
    Sym(n->lib, "nvmlDeviceGetP2PStatus", &n->p2p);
    Sym(n->lib, "nvmlDeviceGetGpuFabricInfoV", &n->fabric);
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

// the calls NVML refused for one card, as the "refused" object's members
struct Refusals {
  std::string json;
  void Add(const Nvml& n, unsigned int i, const char* call, nvmlReturn_t rc) {
    Refused(n, i, call, rc);
    Member(call, std::to_string(rc));
  }
  void Absent(const char* call) { Member(call, "null"); }
  void Member(const char* call, const std::string& value) {
    if (!json.empty()) json += ", ";
    json += std::string("\"") + call + "\": " + value;
  }
};

const char* RemoteName(int type) {
  switch (type) {
    case 0: return "\"gpu\"";
    case 1: return "\"ibmnpu\"";
    case 2: return "\"nvswitch\"";
    default: return "\"unknown\"";
  }
}

// "nvlink": the active links and what each reaches, or null
void PrintNvLinks(const Nvml& n, unsigned int i, nvmlDevice_t dev,
                  Refusals* refused) {
  printf(", \"nvlink\": ");
  if (!n.nvlink_state) {
    refused->Absent("nvmlDeviceGetNvLinkState");
    printf("null");
    return;
  }
  std::string links;
  bool remote_noted = false;  // one refusal of the remote's type a card
  for (unsigned int link = 0; link < NVML_NVLINK_MAX_LINKS; ++link) {
    int active = 0;
    nvmlReturn_t rc = n.nvlink_state(dev, link, &active);
    if (rc == NVML_ERROR_INVALID_ARGUMENT) continue;  // no such link
    if (rc != NVML_SUCCESS) {
      // one refused link makes the list incomplete: report none
      refused->Add(n, i, "nvmlDeviceGetNvLinkState", rc);
      printf("null");
      return;
    }
    if (active != NVML_FEATURE_ENABLED) continue;
    std::string remote = "null";
    int type = 0;
    if (!n.nvlink_remote) {
      if (!remote_noted) refused->Absent("nvmlDeviceGetNvLinkRemoteDeviceType");
      remote_noted = true;
    } else if ((rc = n.nvlink_remote(dev, link, &type)) == NVML_SUCCESS) {
      remote = RemoteName(type);
    } else {
      if (!remote_noted) {
        refused->Add(n, i, "nvmlDeviceGetNvLinkRemoteDeviceType", rc);
      }
      remote_noted = true;
    }
    if (!links.empty()) links += ", ";
    links += "{\"link\": " + std::to_string(link) + ", \"remote\": " + remote +
             "}";
  }
  printf("[%s]", links.c_str());
}

// "nvlink_peers": the other cards NVML reports reachable over NVLink
void PrintPeers(const Nvml& n, unsigned int i, nvmlDevice_t dev,
                const std::vector<std::pair<unsigned int, nvmlDevice_t>>& all,
                Refusals* refused) {
  printf(", \"nvlink_peers\": ");
  if (!n.p2p) {
    refused->Absent("nvmlDeviceGetP2PStatus");
    printf("null");
    return;
  }
  std::string peers;
  for (const auto& other : all) {
    if (other.first == i) continue;
    int status = -1;
    nvmlReturn_t rc = n.p2p(dev, other.second, NVML_P2P_CAPS_INDEX_NVLINK,
                            &status);
    if (rc != NVML_SUCCESS) {
      refused->Add(n, i, "nvmlDeviceGetP2PStatus", rc);
      printf("null");
      return;
    }
    if (status != NVML_P2P_STATUS_OK) continue;
    if (!peers.empty()) peers += ", ";
    peers += "\"gpu" + std::to_string(other.first) + "\"";
  }
  printf("[%s]", peers.c_str());
}

// "fabric": the card's NVLink fabric registration, or null
void PrintFabric(const Nvml& n, unsigned int i, nvmlDevice_t dev,
                 Refusals* refused) {
  printf(", \"fabric\": ");
  if (!n.fabric) {
    refused->Absent("nvmlDeviceGetGpuFabricInfoV");
    printf("null");
    return;
  }
  // the newest layout first; a library that predates it names the
  // mismatch, and the older one is asked
  nvmlGpuFabricInfo_t info;
  nvmlReturn_t rc = NVML_ERROR_ARGUMENT_VERSION_MISMATCH;
  for (unsigned int version :
       {NVML_GPU_FABRIC_INFO_V3, NVML_GPU_FABRIC_INFO_V2}) {
    memset(&info, 0, sizeof(info));
    info.version = version;
    rc = n.fabric(dev, &info);
    if (rc != NVML_ERROR_ARGUMENT_VERSION_MISMATCH) break;
  }
  if (rc != NVML_SUCCESS) {
    refused->Add(n, i, "nvmlDeviceGetGpuFabricInfoV", rc);
    printf("null");
    return;
  }
  char uuid[40];
  const unsigned char* u = info.cluster_uuid;
  snprintf(uuid, sizeof(uuid),
           "%02x%02x%02x%02x-%02x%02x-%02x%02x-%02x%02x-"
           "%02x%02x%02x%02x%02x%02x",
           u[0], u[1], u[2], u[3], u[4], u[5], u[6], u[7], u[8], u[9], u[10],
           u[11], u[12], u[13], u[14], u[15]);
  printf("{\"cluster_uuid\": \"%s\", \"clique_id\": %u, \"state\": ", uuid,
         info.clique_id);
  if (info.state < 4) {
    printf("\"%s\"", FABRIC_STATES[info.state]);
  } else {
    printf("\"state %u\"", info.state);
  }
  printf(", \"status\": %d}", info.status);
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
  const nvmlReturn_t driver_rc = n->driver_version(buf, sizeof(buf));
  if (driver_rc != NVML_SUCCESS) {
    fprintf(stderr, "gpu-telemetry: nvmlSystemGetDriverVersion: %s (%d)\n",
            n->error_string ? n->error_string(driver_rc) : "error",
            driver_rc);
  }
  std::vector<std::pair<unsigned int, nvmlDevice_t>> devices;
  for (unsigned int i = 0; i < cards; ++i) {
    nvmlDevice_t dev = nullptr;
    if ((rc = n->handle(i, &dev)) != NVML_SUCCESS) {
      Refused(*n, i, "nvmlDeviceGetHandleByIndex_v2", rc);
      continue;
    }
    devices.emplace_back(i, dev);
  }
  printf("{\"driver_version\": ");
  PrintString(buf, driver_rc == NVML_SUCCESS);
  printf(", \"cards\": [");
  for (size_t k = 0; k < devices.size(); ++k) {
    const unsigned int i = devices[k].first;
    nvmlDevice_t dev = devices[k].second;
    if (k > 0) printf(", ");
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
    printf(", \"memory_total_bytes\": %llu", mem.total);
    Refusals refused;
    PrintNvLinks(*n, i, dev, &refused);
    PrintPeers(*n, i, dev, devices, &refused);
    PrintFabric(*n, i, dev, &refused);
    printf(", \"refused\": {%s}}", refused.json.c_str());
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

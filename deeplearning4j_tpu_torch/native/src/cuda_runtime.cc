// dl4j native runtime over the CUDA driver: the port's counterpart of
// deeplearning4j_tpu/native/src/pjrt_runtime.cc.
//
// The JAX library dlopens a PJRT plugin, compiles StableHLO into an
// in-process executable cache keyed by content, stages inputs host->device
// and outputs device->host, and executes synchronously. This one dlopens
// the CUDA driver (libcuda.so.1) the same way and keeps the same flat C
// ABI, entry-point names and PJRT dtype codes. What it compiles is a CUDA
// graph the frontend captured: on a cache miss dl4j_compile calls the
// frontend's lowering hook, which builds the program on the card and
// captures it (returning the cudaGraph_t and the static input and output
// buffers the graph reads and writes); the library instantiates its own
// executable from that graph and caches it under the program's content
// hash. dl4j_execute copies host inputs (host->device) and device inputs
// (device->device) into the static inputs, launches the executable on the
// caller's stream, copies the static outputs to malloc'd host buffers and
// synchronizes. No kernel lives here.
//
// Contexts: the library retains each device's PRIMARY context (the one
// PyTorch uses) and makes it current on the calling thread for every
// call; it never creates a context of its own.
//
// Lifetimes: an executable's nodes point into memory the frontend owns
// (the capture's memory pool and the static buffers). Each cache entry
// carries the frontend's token for that memory; dl4j_executable_release
// returns the token when the entry's last handle goes, after the
// executable is destroyed, so the frontend frees the memory then and not
// before.
//
// Threads: one mutex guards the cache and its counters, one serializes
// compiles (a lowering runs outside the cache lock), and one serializes
// executions: the executables of one frontend share one memory pool, so
// two of them must never run at once.
//
// Build: g++ -shared -fPIC -O2 -std=c++17 cuda_runtime.cc -ldl. The driver
// prototypes it calls are declared below, so no CUDA header is needed.

#include <dlfcn.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include <cstdio>
#include <map>
#include <mutex>
#include <string>
#include <vector>

namespace {

// ------------------------------------------------------- driver prototypes
typedef int CUresult;
typedef int CUdevice;
typedef struct CUctx_st* CUcontext;
typedef struct CUstream_st* CUstream;
typedef struct CUgraph_st* CUgraph;
typedef struct CUgraphExec_st* CUgraphExec;
typedef unsigned long long CUdeviceptr;

const int CU_POINTER_ATTRIBUTE_MEMORY_TYPE = 2;
const unsigned int CU_MEMORYTYPE_DEVICE = 2;

struct Driver {
  CUresult (*cuInit)(unsigned int);
  CUresult (*cuDriverGetVersion)(int*);
  CUresult (*cuDeviceGetCount)(int*);
  CUresult (*cuDeviceGet)(CUdevice*, int);
  CUresult (*cuDevicePrimaryCtxRetain)(CUcontext*, CUdevice);
  CUresult (*cuDevicePrimaryCtxRelease)(CUdevice);
  CUresult (*cuCtxSetCurrent)(CUcontext);
  CUresult (*cuStreamSynchronize)(CUstream);
  CUresult (*cuPointerGetAttribute)(void*, int, CUdeviceptr);
  CUresult (*cuMemcpyHtoDAsync)(CUdeviceptr, const void*, size_t, CUstream);
  CUresult (*cuMemcpyDtoDAsync)(CUdeviceptr, CUdeviceptr, size_t, CUstream);
  CUresult (*cuMemcpyDtoHAsync)(void*, CUdeviceptr, size_t, CUstream);
  CUresult (*cuGraphInstantiateWithFlags)(CUgraphExec*, CUgraph,
                                          unsigned long long);
  CUresult (*cuGraphLaunch)(CUgraphExec, CUstream);
  CUresult (*cuGraphExecDestroy)(CUgraphExec);
  CUresult (*cuGetErrorName)(CUresult, const char**);
  CUresult (*cuGetErrorString)(CUresult, const char**);
};

// (field, symbol): the versioned names are the ones the driver exports for
// the 64-bit pointer ABI
bool resolve(void* h, Driver* d, std::string* missing) {
  struct Sym {
    void** slot;
    const char* name;
  };
  Sym syms[] = {
      {reinterpret_cast<void**>(&d->cuInit), "cuInit"},
      {reinterpret_cast<void**>(&d->cuDriverGetVersion), "cuDriverGetVersion"},
      {reinterpret_cast<void**>(&d->cuDeviceGetCount), "cuDeviceGetCount"},
      {reinterpret_cast<void**>(&d->cuDeviceGet), "cuDeviceGet"},
      {reinterpret_cast<void**>(&d->cuDevicePrimaryCtxRetain),
       "cuDevicePrimaryCtxRetain"},
      {reinterpret_cast<void**>(&d->cuDevicePrimaryCtxRelease),
       "cuDevicePrimaryCtxRelease_v2"},
      {reinterpret_cast<void**>(&d->cuCtxSetCurrent), "cuCtxSetCurrent"},
      {reinterpret_cast<void**>(&d->cuStreamSynchronize),
       "cuStreamSynchronize"},
      {reinterpret_cast<void**>(&d->cuPointerGetAttribute),
       "cuPointerGetAttribute"},
      {reinterpret_cast<void**>(&d->cuMemcpyHtoDAsync), "cuMemcpyHtoDAsync_v2"},
      {reinterpret_cast<void**>(&d->cuMemcpyDtoDAsync), "cuMemcpyDtoDAsync_v2"},
      {reinterpret_cast<void**>(&d->cuMemcpyDtoHAsync), "cuMemcpyDtoHAsync_v2"},
      {reinterpret_cast<void**>(&d->cuGraphInstantiateWithFlags),
       "cuGraphInstantiateWithFlags"},
      {reinterpret_cast<void**>(&d->cuGraphLaunch), "cuGraphLaunch"},
      {reinterpret_cast<void**>(&d->cuGraphExecDestroy), "cuGraphExecDestroy"},
      {reinterpret_cast<void**>(&d->cuGetErrorName), "cuGetErrorName"},
      {reinterpret_cast<void**>(&d->cuGetErrorString), "cuGetErrorString"},
  };
  for (const Sym& s : syms) {
    *s.slot = dlsym(h, s.name);
    if (!*s.slot) {
      *missing = s.name;
      return false;
    }
  }
  return true;
}

void set_err(char* err, size_t errlen, const std::string& msg) {
  if (err && errlen > 0) snprintf(err, errlen, "%s", msg.c_str());
}

std::string cu_message(const Driver& d, const char* call, CUresult rc) {
  const char* name = nullptr;
  const char* text = nullptr;
  d.cuGetErrorName(rc, &name);
  d.cuGetErrorString(rc, &text);
  std::string msg = std::string(call) + ": ";
  msg += name ? name : ("CUresult " + std::to_string(rc));
  if (text) msg += std::string(" (") + text + ")";
  return msg;
}

uint64_t fnv1a(const char* data, size_t n,
               uint64_t seed = 1469598103934665603ull) {
  uint64_t h = seed;
  for (size_t i = 0; i < n; ++i) {
    h ^= static_cast<unsigned char>(data[i]);
    h *= 1099511628211ull;
  }
  return h;
}

size_t dtype_nbytes(int32_t t) {
  switch (t) {
    case 1: case 2: case 6:              // PRED, S8, U8
      return 1;
    case 3: case 7: case 10: case 13:    // S16, U16, F16, BF16
      return 2;
    case 4: case 8: case 11:             // S32, U32, F32
      return 4;
    case 5: case 9: case 12: case 14:    // S64, U64, F64, C64
      return 8;
    case 15:                             // C128
      return 16;
    default:
      return 0;
  }
}

std::string describe(int32_t dtype, int32_t ndim, const int64_t* dims) {
  std::string s = "dtype " + std::to_string(dtype) + " [";
  for (int32_t i = 0; i < ndim; ++i) {
    if (i) s += ", ";
    s += std::to_string(dims[i]);
  }
  return s + "]";
}

}  // namespace

extern "C" {

// Output buffer handed back to the frontend (dense, major-to-minor).
typedef struct {
  void* data;        // malloc'd; free via dl4j_free_outputs
  int32_t dtype;     // PJRT_Buffer_Type
  int32_t ndim;
  int64_t dims[16];
  int64_t nbytes;
} Dl4jHostBuffer;

// A static buffer of a captured graph, on the card.
typedef struct {
  void* ptr;
  int32_t dtype;
  int32_t ndim;
  int64_t dims[16];
  int64_t nbytes;
} Dl4jDeviceBuffer;

// What the frontend's lowering hands back for one program.
typedef struct {
  void* graph;             // the captured CUgraph (the frontend owns it)
  int32_t device;          // ordinal the graph was captured on
  int32_t n_inputs;
  int32_t n_outputs;
  Dl4jDeviceBuffer* inputs;
  Dl4jDeviceBuffer* outputs;
  int64_t token;           // the frontend's handle on what must outlive
                           // the executable (the pool, the buffers)
} Dl4jLowered;

// The lowering hook dl4j_compile calls on a cache miss: returns 0 and
// fills `out`, or non-zero with a message in err.
typedef int (*Dl4jLowerFn)(void* user, const char* program, int64_t size,
                           const char* format, Dl4jLowered* out, char* err,
                           size_t errlen);

// dl4j_compile's `options` for the "samediff" format.
typedef struct {
  Dl4jLowerFn lower;
  void* user;
} Dl4jLowering;

}  // extern "C"

namespace {

// A lowered buffer must be dense: nbytes = itemsize * elements.
bool dense(const Dl4jDeviceBuffer& b) {
  if (b.ndim < 0 || b.ndim > 16 || dtype_nbytes(b.dtype) == 0) return false;
  int64_t n = static_cast<int64_t>(dtype_nbytes(b.dtype));
  for (int32_t k = 0; k < b.ndim; ++k) n *= b.dims[k];
  return n == b.nbytes;
}

struct Entry {
  uint64_t key = 0;
  CUgraphExec exec = nullptr;
  int32_t device = 0;
  std::vector<Dl4jDeviceBuffer> inputs;
  std::vector<Dl4jDeviceBuffer> outputs;
  int64_t token = 0;
  int refs = 0;
};

struct Dl4jClient {
  void* dl_handle = nullptr;
  Driver drv;
  int driver_version = 0;
  int n_devices = 0;
  std::vector<CUcontext> ctx;       // retained primary contexts, lazily
  std::map<uint64_t, Entry*> cache;
  std::mutex mu;                    // cache, counters, contexts
  std::mutex compile_mu;            // one compile at a time
  std::mutex exec_mu;               // one execution at a time
  int64_t hits = 0;
  int64_t misses = 0;
};

struct Dl4jExecutable {
  Dl4jClient* owner = nullptr;
  Entry* entry = nullptr;
};

// Retain device `ordinal`'s primary context (once) and make it current.
bool make_current(Dl4jClient* c, int ordinal, std::string* msg) {
  if (ordinal < 0 || ordinal >= c->n_devices) {
    *msg = "device ordinal " + std::to_string(ordinal) + " out of range (" +
           std::to_string(c->n_devices) + " devices)";
    return false;
  }
  CUcontext ctx;
  {
    std::lock_guard<std::mutex> lock(c->mu);
    ctx = c->ctx[ordinal];
    if (!ctx) {
      CUdevice dev;
      CUresult rc = c->drv.cuDeviceGet(&dev, ordinal);
      if (rc) {
        *msg = cu_message(c->drv, "cuDeviceGet", rc);
        return false;
      }
      rc = c->drv.cuDevicePrimaryCtxRetain(&ctx, dev);
      if (rc) {
        *msg = cu_message(c->drv, "cuDevicePrimaryCtxRetain", rc);
        return false;
      }
      c->ctx[ordinal] = ctx;
    }
  }
  CUresult rc = c->drv.cuCtxSetCurrent(ctx);
  if (rc) {
    *msg = cu_message(c->drv, "cuCtxSetCurrent", rc);
    return false;
  }
  return true;
}

void destroy_exec(Dl4jClient* c, Entry* e) {
  std::string ignored;
  if (e->exec && make_current(c, e->device, &ignored))
    c->drv.cuGraphExecDestroy(e->exec);
  e->exec = nullptr;
}

}  // namespace

extern "C" {

void dl4j_client_destroy(void* vc);
void dl4j_free_outputs(Dl4jHostBuffer* outs, int n);

// ---- client lifecycle ----------------------------------------------------

// Create options follow the JAX ABI (n_opts parallel arrays; types[i]:
// 0 = string, 1 = int64). The CUDA driver takes none, so any option is
// refused by name.
void* dl4j_client_create(const char* driver_path, int n_opts,
                         const char* const* opt_keys,
                         const int32_t* opt_types,
                         const char* const* opt_strs,
                         const int64_t* opt_ints, char* err, size_t errlen) {
  (void)opt_types;
  (void)opt_strs;
  (void)opt_ints;
  if (n_opts > 0) {
    set_err(err, errlen, std::string("unknown create option '") +
                             opt_keys[0] + "': the CUDA driver takes none");
    return nullptr;
  }
  void* h = dlopen(driver_path, RTLD_NOW | RTLD_LOCAL);
  if (!h) {
    set_err(err, errlen, std::string("dlopen failed: ") + dlerror());
    return nullptr;
  }
  Dl4jClient* c = new Dl4jClient();
  c->dl_handle = h;
  std::string missing;
  if (!resolve(h, &c->drv, &missing)) {
    set_err(err, errlen, std::string(driver_path) + " exports no " + missing);
    delete c;
    return nullptr;
  }
  CUresult rc = c->drv.cuInit(0);
  if (rc) {
    set_err(err, errlen, cu_message(c->drv, "cuInit", rc));
    delete c;
    return nullptr;
  }
  rc = c->drv.cuDriverGetVersion(&c->driver_version);
  if (!rc) rc = c->drv.cuDeviceGetCount(&c->n_devices);
  if (rc) {
    set_err(err, errlen, cu_message(c->drv, "cuDeviceGetCount", rc));
    delete c;
    return nullptr;
  }
  if (c->n_devices <= 0) {
    set_err(err, errlen, "the CUDA driver sees no device");
    delete c;
    return nullptr;
  }
  c->ctx.assign(c->n_devices, nullptr);
  // NOTE: the driver stays loaded for the process's lifetime, as the JAX
  // library keeps its plugin: PyTorch holds the same library.
  return c;
}

void dl4j_client_destroy(void* vc) {
  Dl4jClient* c = static_cast<Dl4jClient*>(vc);
  if (!c) return;
  {
    std::lock_guard<std::mutex> exec_lock(c->exec_mu);
    for (auto& kv : c->cache) {
      destroy_exec(c, kv.second);
      delete kv.second;
    }
    c->cache.clear();
  }
  for (int d = 0; d < c->n_devices; ++d) {
    if (!c->ctx[d]) continue;
    CUdevice dev;
    if (!c->drv.cuDeviceGet(&dev, d)) c->drv.cuDevicePrimaryCtxRelease(dev);
  }
  delete c;
}

int dl4j_client_device_count(void* vc) {
  Dl4jClient* c = static_cast<Dl4jClient*>(vc);
  return c ? c->n_devices : 0;
}

int dl4j_client_platform_name(void* vc, char* out, size_t outlen) {
  Dl4jClient* c = static_cast<Dl4jClient*>(vc);
  if (!c || outlen == 0) return -1;
  return snprintf(out, outlen, "%s", "cuda");
}

// The driver's version: 12040 -> (12, 4).
int dl4j_client_api_version(void* vc, int* major, int* minor) {
  Dl4jClient* c = static_cast<Dl4jClient*>(vc);
  if (!c) return -1;
  *major = c->driver_version / 1000;
  *minor = (c->driver_version % 1000) / 10;
  return 0;
}

// ---- compile (with the in-process executable cache) ----------------------

// `format` "samediff": `code` is the program (its content key, with the
// format), `options` a Dl4jLowering the library calls on a miss.
void* dl4j_compile(void* vc, const char* code, int64_t code_size,
                   const char* format, const char* options,
                   int64_t options_size, int* cache_hit, char* err,
                   size_t errlen) {
  Dl4jClient* c = static_cast<Dl4jClient*>(vc);
  if (!c) {
    set_err(err, errlen, "null client");
    return nullptr;
  }
  if (strcmp(format, "samediff") != 0) {
    set_err(err, errlen, std::string("compile failed: format '") + format +
                             "' is not compiled by the CUDA runtime (it "
                             "takes 'samediff', a captured SameDiff graph)");
    return nullptr;
  }
  if (!options || options_size != static_cast<int64_t>(sizeof(Dl4jLowering))) {
    set_err(err, errlen, "compile failed: the 'samediff' format needs a "
                         "Dl4jLowering as its options");
    return nullptr;
  }
  Dl4jLowering hook;
  memcpy(&hook, options, sizeof(hook));
  uint64_t key = fnv1a(code, code_size);
  key = fnv1a(format, strlen(format), key);

  std::lock_guard<std::mutex> compile_lock(c->compile_mu);
  {
    std::lock_guard<std::mutex> lock(c->mu);
    auto it = c->cache.find(key);
    if (it != c->cache.end()) {
      c->hits++;
      it->second->refs++;
      if (cache_hit) *cache_hit = 1;
      Dl4jExecutable* e = new Dl4jExecutable();
      e->owner = c;
      e->entry = it->second;
      return e;
    }
  }
  if (cache_hit) *cache_hit = 0;

  Dl4jLowered low;
  memset(&low, 0, sizeof(low));
  char lower_err[2048] = {0};
  if (hook.lower(hook.user, code, code_size, format, &low, lower_err,
                 sizeof(lower_err)) != 0) {
    set_err(err, errlen, std::string("compile failed: ") + lower_err);
    return nullptr;
  }
  for (int32_t i = 0; i < low.n_inputs + low.n_outputs; ++i) {
    bool in = i < low.n_inputs;
    const Dl4jDeviceBuffer& b = in ? low.inputs[i]
                                   : low.outputs[i - low.n_inputs];
    if (!dense(b)) {
      set_err(err, errlen, std::string("compile failed: the lowering's ") +
                               (in ? "input " : "output ") +
                               std::to_string(in ? i : i - low.n_inputs) +
                               " is not a dense buffer: " +
                               describe(b.dtype, b.ndim, b.dims) + ", " +
                               std::to_string(b.nbytes) + " bytes");
      return nullptr;
    }
  }
  Entry* entry = new Entry();
  entry->key = key;
  entry->device = low.device;
  entry->token = low.token;
  entry->refs = 1;
  entry->inputs.assign(low.inputs, low.inputs + low.n_inputs);
  entry->outputs.assign(low.outputs, low.outputs + low.n_outputs);
  std::string msg;
  CUresult rc = 0;
  if (make_current(c, low.device, &msg)) {
    rc = c->drv.cuGraphInstantiateWithFlags(
        &entry->exec, static_cast<CUgraph>(low.graph), 0);
    if (rc) msg = cu_message(c->drv, "cuGraphInstantiateWithFlags", rc);
  }
  if (!msg.empty()) {
    // the frontend still owns the lowered memory: it frees it on error
    set_err(err, errlen, "compile failed: " + msg);
    delete entry;
    return nullptr;
  }
  {
    std::lock_guard<std::mutex> lock(c->mu);
    c->misses++;
    c->cache[key] = entry;
  }
  Dl4jExecutable* e = new Dl4jExecutable();
  e->owner = c;
  e->entry = entry;
  return e;
}

// Free a handle. Returns the frontend's token when this was the entry's
// last handle (the executable is destroyed and the entry leaves the cache:
// the frontend may free the entry's memory now), else 0.
int64_t dl4j_executable_release(void* ve) {
  Dl4jExecutable* e = static_cast<Dl4jExecutable*>(ve);
  if (!e) return 0;
  Dl4jClient* c = e->owner;
  Entry* entry = e->entry;
  delete e;
  {
    std::lock_guard<std::mutex> lock(c->mu);
    if (--entry->refs > 0) return 0;
    c->cache.erase(entry->key);
  }
  std::lock_guard<std::mutex> exec_lock(c->exec_mu);
  destroy_exec(c, entry);
  int64_t token = entry->token;
  delete entry;
  return token;
}

// The frontend's token of the entry behind a handle (a cache hit shares
// the token of the compile that lowered it).
int64_t dl4j_executable_token(void* ve) {
  Dl4jExecutable* e = static_cast<Dl4jExecutable*>(ve);
  return e ? e->entry->token : 0;
}

int64_t dl4j_executable_num_outputs(void* ve) {
  Dl4jExecutable* e = static_cast<Dl4jExecutable*>(ve);
  return e ? static_cast<int64_t>(e->entry->outputs.size()) : -1;
}

int64_t dl4j_client_cache_stats(void* vc, int64_t* hits, int64_t* misses) {
  Dl4jClient* c = static_cast<Dl4jClient*>(vc);
  if (!c) return -1;
  std::lock_guard<std::mutex> lock(c->mu);
  if (hits) *hits = c->hits;
  if (misses) *misses = c->misses;
  return static_cast<int64_t>(c->cache.size());
}

// ---- execute -------------------------------------------------------------

// Synchronous execute: inputs {data, dtype, ndim, dims} in the program's
// order, each on the host or on the card (the driver says which); copied
// into the static inputs, the executable launched on `stream` (NULL: the
// legacy default stream), the static outputs copied to malloc'd host
// buffers. Returns the output count, or -1 with a message in err.
int dl4j_execute(void* ve, int n_in, void** in_data, const int32_t* in_dtypes,
                 const int32_t* in_ndims, const int64_t* in_dims_flat,
                 int device_ordinal, void* stream, Dl4jHostBuffer* outs,
                 int max_outs, char* err, size_t errlen) {
  Dl4jExecutable* e = static_cast<Dl4jExecutable*>(ve);
  if (!e) {
    set_err(err, errlen, "null executable");
    return -1;
  }
  Dl4jClient* c = e->owner;
  Entry* entry = e->entry;
  const Driver& d = c->drv;
  CUstream s = static_cast<CUstream>(stream);
  if (device_ordinal != entry->device) {
    set_err(err, errlen, "the executable was captured on device " +
                             std::to_string(entry->device) + ", not " +
                             std::to_string(device_ordinal));
    return -1;
  }
  if (n_in != static_cast<int>(entry->inputs.size())) {
    set_err(err, errlen, "the program takes " +
                             std::to_string(entry->inputs.size()) +
                             " inputs, got " + std::to_string(n_in));
    return -1;
  }
  size_t n_out = entry->outputs.size();
  if (static_cast<int>(n_out) > max_outs) {
    set_err(err, errlen, "output count exceeds caller capacity");
    return -1;
  }
  // signatures first: nothing moves unless every input fits its buffer
  const int64_t* dims = in_dims_flat;
  for (int i = 0; i < n_in; ++i) {
    const Dl4jDeviceBuffer& b = entry->inputs[i];
    bool same = in_dtypes[i] == b.dtype && in_ndims[i] == b.ndim;
    for (int32_t k = 0; same && k < b.ndim; ++k) same = dims[k] == b.dims[k];
    if (!same) {
      set_err(err, errlen, "input " + std::to_string(i) + ": the program "
                           "takes " + describe(b.dtype, b.ndim, b.dims) +
                           ", got " + describe(in_dtypes[i], in_ndims[i],
                                               dims));
      return -1;
    }
    dims += in_ndims[i];
  }

  memset(outs, 0, n_out * sizeof(*outs));
  std::lock_guard<std::mutex> exec_lock(c->exec_mu);
  std::string msg;
  if (!make_current(c, entry->device, &msg)) {
    set_err(err, errlen, msg);
    return -1;
  }
  CUresult rc = 0;
  for (int i = 0; i < n_in && !rc; ++i) {
    const Dl4jDeviceBuffer& b = entry->inputs[i];
    if (b.nbytes == 0 || in_data[i] == b.ptr) continue;
    CUdeviceptr src = reinterpret_cast<CUdeviceptr>(in_data[i]);
    unsigned int mem_type = 0;
    // unregistered host memory is no driver pointer: the query fails
    bool on_card = d.cuPointerGetAttribute(&mem_type,
                                           CU_POINTER_ATTRIBUTE_MEMORY_TYPE,
                                           src) == 0 &&
                   mem_type == CU_MEMORYTYPE_DEVICE;
    CUdeviceptr dst = reinterpret_cast<CUdeviceptr>(b.ptr);
    rc = on_card ? d.cuMemcpyDtoDAsync(dst, src, b.nbytes, s)
                 : d.cuMemcpyHtoDAsync(dst, in_data[i], b.nbytes, s);
    if (rc)
      msg = cu_message(d, on_card ? "cuMemcpyDtoDAsync" : "cuMemcpyHtoDAsync",
                       rc) + " (input " + std::to_string(i) + ")";
  }
  if (!rc) {
    rc = d.cuGraphLaunch(entry->exec, s);
    if (rc) msg = cu_message(d, "cuGraphLaunch", rc);
  }
  for (size_t o = 0; o < n_out && !rc; ++o) {
    const Dl4jDeviceBuffer& b = entry->outputs[o];
    Dl4jHostBuffer* hb = &outs[o];
    hb->dtype = b.dtype;
    hb->ndim = b.ndim;
    memcpy(hb->dims, b.dims, sizeof(hb->dims));
    hb->nbytes = b.nbytes;
    if (b.nbytes == 0) continue;
    hb->data = malloc(b.nbytes);
    if (!hb->data) {
      msg = "out of host memory for output " + std::to_string(o);
      rc = -1;
      break;
    }
    rc = d.cuMemcpyDtoHAsync(hb->data, reinterpret_cast<CUdeviceptr>(b.ptr),
                             b.nbytes, s);
    if (rc) msg = cu_message(d, "cuMemcpyDtoHAsync", rc);
  }
  // the outputs are the caller's only once the stream has drained
  CUresult sync = d.cuStreamSynchronize(s);
  if (!rc && sync) {
    rc = sync;
    msg = cu_message(d, "cuStreamSynchronize", sync);
  }
  if (rc) {
    dl4j_free_outputs(outs, static_cast<int>(n_out));
    set_err(err, errlen, msg);
    return -1;
  }
  return static_cast<int>(n_out);
}

void dl4j_free_outputs(Dl4jHostBuffer* outs, int n) {
  for (int i = 0; i < n; ++i) {
    free(outs[i].data);
    outs[i].data = nullptr;
  }
}

}  // extern "C"

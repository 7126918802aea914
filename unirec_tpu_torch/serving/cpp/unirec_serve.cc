// unirec_serve: the C++ serving client of unirec_tpu_torch.
//
// Plays the role of the JAX package's examples/serving_cpp/unirec_serve.cc:
// a native program that loads an exported model and serves user embeddings,
// item embeddings or (user, candidate) scores with no Python on the path.
// The artifact is an AOTInductor package written by
//   python -m unirec_tpu_torch.cli export --model_file ckpt.pkl --out_dir art \
//       --aoti score --aoti_batch 256
// (art/score.aoti.pt2, a fixed-batch program), loaded with libtorch's
// AOTIModelPackageLoader.
//
// The fused kernels are the unirec::* operators (ops/op_schemas.py). This
// client registers every schema of that table with TORCH_LIBRARY (the
// strings come from a header its build writes, serving/cpp/build.py) and
// implements unirec::layer_fwd and unirec::lastq_fwd (rows 1 and 3) on CUDA
// as thin shims over the C launchers of csrc/layer_fwd.cu and
// csrc/lastq_fwd.cu: it dlopens the kernel libraries named by --lib, makes
// the operands contiguous (and 16-byte aligned for the tensor-core bodies,
// which the library's *_mma_takes admits, as ops/layer.py does) and launches
// on the current stream. Before loading a package it reads the package's
// metadata "unirec_ops" and refuses, by name, one that calls an operator it
// does not implement on the package's device. It counts each operator's
// launches and prints them.
//
//   usage: unirec_serve <package.pt2> <inputs.bin> <outputs.bin>
//              [--lib NAME=PATH ...] [--repeat N]
//          unirec_serve --schemas
//
// Tensor container format (little-endian), serving/cpp/tensor_io.py:
//   u32 magic 'UTSR' | u32 n_tensors
//   per tensor: u32 dtype (0=f32, 1=s32) | u32 ndim | u64 dims[ndim] | raw data
//
// Build: serving/cpp/build.py (g++ against the installed torch's libtorch;
// with -DUNIREC_WITH_CUDA where torch is built for CUDA).

#include <dlfcn.h>

#include <ATen/ATen.h>
#include <ATen/core/dispatch/Dispatcher.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#include <torch/library.h>

#ifdef UNIREC_WITH_CUDA
#include <c10/cuda/CUDAFunctions.h>
#include <c10/cuda/CUDAStream.h>
#endif

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <fstream>
#include <map>
#include <set>
#include <sstream>
#include <string>
#include <vector>

#include "unirec_schemas.h"  // kUnirecSchemas: {name, schema} of ops/op_schemas.py

namespace {

[[noreturn]] void Die(const std::string& msg, int code = 1) {
  std::fprintf(stderr, "unirec_serve: %s\n", msg.c_str());
  std::exit(code);
}

// ---------------------------------------------------------------- tensor io
constexpr uint32_t kMagic = 0x55545352;  // 'UTSR'

std::vector<at::Tensor> ReadTensors(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) Die("cannot open " + path);
  uint32_t magic = 0, n = 0;
  f.read(reinterpret_cast<char*>(&magic), 4);
  f.read(reinterpret_cast<char*>(&n), 4);
  if (magic != kMagic) Die(path + ": bad magic");
  std::vector<at::Tensor> out;
  for (uint32_t i = 0; i < n; ++i) {
    uint32_t dtype = 0, ndim = 0;
    f.read(reinterpret_cast<char*>(&dtype), 4);
    f.read(reinterpret_cast<char*>(&ndim), 4);
    std::vector<int64_t> dims(ndim);
    for (auto& d : dims) {
      uint64_t v = 0;
      f.read(reinterpret_cast<char*>(&v), 8);
      d = static_cast<int64_t>(v);
    }
    if (dtype > 1) Die(path + ": unknown dtype code");
    at::Tensor t = at::empty(dims, dtype == 0 ? at::kFloat : at::kInt);
    f.read(reinterpret_cast<char*>(t.data_ptr()),
           static_cast<std::streamsize>(t.numel() * 4));
    if (!f) Die(path + ": truncated tensor data");
    out.push_back(t);
  }
  return out;
}

void WriteTensors(const std::string& path, const std::vector<at::Tensor>& ts) {
  std::ofstream f(path, std::ios::binary);
  if (!f) Die("cannot open " + path + " for writing");
  uint32_t n = static_cast<uint32_t>(ts.size());
  f.write(reinterpret_cast<const char*>(&kMagic), 4);
  f.write(reinterpret_cast<const char*>(&n), 4);
  for (const auto& t0 : ts) {
    at::Tensor t = t0.to(at::kCPU, at::kFloat).contiguous();
    uint32_t dtype = 0, ndim = static_cast<uint32_t>(t.dim());
    f.write(reinterpret_cast<const char*>(&dtype), 4);
    f.write(reinterpret_cast<const char*>(&ndim), 4);
    for (int64_t d : t.sizes()) {
      uint64_t v = static_cast<uint64_t>(d);
      f.write(reinterpret_cast<const char*>(&v), 8);
    }
    f.write(reinterpret_cast<const char*>(t.data_ptr()),
            static_cast<std::streamsize>(t.numel() * 4));
  }
}

// ------------------------------------------------------- kernel libraries
std::map<std::string, void*>& Libraries() {
  static std::map<std::string, void*> libs;
  return libs;
}

void* Symbol(const std::string& lib, const std::string& name) {
  auto it = Libraries().find(lib);
  TORCH_CHECK(it != Libraries().end(), "unirec_serve: no --lib ", lib,
              "=<path> was given for unirec::", lib);
  void* p = dlsym(it->second, name.c_str());
  TORCH_CHECK(p != nullptr, "unirec_serve: ", name, " not found in the ", lib,
              " library");
  return p;
}

std::map<std::string, int64_t>& Launches() {
  static std::map<std::string, int64_t> counts;
  return counts;
}

constexpr int64_t kSmemLimit = 232448;  // dynamic shared memory of a block

#ifdef UNIREC_WITH_CUDA
using TakesFn = int (*)(int, int, int, int, int);

int DtypeCode(const at::Tensor& x) {
  if (x.scalar_type() == at::kFloat) return 0;
  if (x.scalar_type() == at::kBFloat16) return 1;
  TORCH_CHECK(false, "unirec_serve: the layer kernels take float32 or bfloat16, got ",
              x.scalar_type());
}

// t on a 16-byte boundary, copied if it is not (the tensor-core bodies
// move 16 bytes at a time): ops/layer.py::_aligned16
at::Tensor Aligned16(const at::Tensor& t) {
  return reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0 ? t : t.clone();
}

void* Ptr(const at::Tensor& t) { return t.data_ptr(); }

void CheckLaunch(int err, const char* what) {
  TORCH_CHECK(err == 0, "unirec_serve: ", what, " launch: CUDA error ", err);
}

// unirec::layer_fwd: csrc/layer_fwd.cu's unirec_layer_fwd (row 1), as
// ops/layer.py::_layer_fwd_cuda launches it
at::Tensor LayerFwdCuda(const at::Tensor& x0, const at::Tensor& madd0, at::TensorList flat0,
                        int64_t nh, int64_t act, bool causal, double eps, int64_t seed,
                        int64_t t_attn, int64_t t_hidden, double inv_attn,
                        double inv_hidden, int64_t b0) {
  TORCH_CHECK(x0.dim() == 3 && flat0.size() == 12, "unirec_serve: layer_fwd operands");
  const int dtype = DtypeCode(x0);
  const int B = x0.size(0), Lp = x0.size(1), D = x0.size(2), F = flat0[6].size(1);
  auto smem = reinterpret_cast<int (*)(int, int, int)>(
      Symbol("layer_fwd", "unirec_layer_fwd_smem_bytes"));
  TORCH_CHECK(D % nh == 0 && Lp % 8 == 0 && smem(Lp, D, F) <= kSmemLimit,
              "unirec_serve: layer kernels do not take Lp=", Lp, ", D=", D, ", F=", F,
              ", nh=", nh);
  const bool mma = reinterpret_cast<TakesFn>(
      Symbol("layer_fwd", "unirec_layer_fwd_mma_takes"))(dtype, Lp, D, F, nh) != 0;
  at::Tensor x = x0.contiguous(), madd = madd0.to(at::kFloat).contiguous();
  std::vector<at::Tensor> flat;
  for (const auto& t : flat0) flat.push_back(t.contiguous());
  if (mma) {
    x = Aligned16(x);
    madd = Aligned16(madd);
    for (int i : {0, 2, 6, 8}) flat[i] = Aligned16(flat[i]);
  }
  at::Tensor y = at::empty_like(x);
  using Fn = int (*)(int, const void*, const void*, const void*, const void*, const void*,
                     const void*, const void*, const void*, const void*, const void*,
                     const void*, const void*, const void*, const void*, void*, int, int, int,
                     int, int, int, int, int, float, unsigned, unsigned, unsigned, float,
                     float, unsigned, void*);
  auto fn = reinterpret_cast<Fn>(Symbol("layer_fwd", "unirec_layer_fwd"));
  void* stream = c10::cuda::getCurrentCUDAStream(x.device().index()).stream();
  CheckLaunch(fn(dtype, Ptr(x), Ptr(madd), Ptr(flat[0]), Ptr(flat[1]), Ptr(flat[2]),
                 Ptr(flat[3]), Ptr(flat[4]), Ptr(flat[5]), Ptr(flat[6]), Ptr(flat[7]),
                 Ptr(flat[8]), Ptr(flat[9]), Ptr(flat[10]), Ptr(flat[11]), Ptr(y), B, Lp, D,
                 F, static_cast<int>(nh), static_cast<int>(act), causal ? 1 : 0, mma ? 1 : 0,
                 static_cast<float>(eps), static_cast<unsigned>(seed),
                 static_cast<unsigned>(t_attn), static_cast<unsigned>(t_hidden),
                 static_cast<float>(inv_attn), static_cast<float>(inv_hidden),
                 static_cast<unsigned>(b0), stream),
              "layer_fwd");
  Launches()["unirec::layer_fwd"] += 1;
  if (mma) Launches()["unirec::layer_fwd (mma)"] += 1;
  return y;
}

// unirec::lastq_fwd: csrc/lastq_fwd.cu's unirec_lastq_fwd (row 3), as
// ops/layer.py::_lastq_fwd_cuda launches it
at::Tensor LastqFwdCuda(const at::Tensor& x0, const at::Tensor& madd0, at::TensorList flat0,
                        int64_t qi, int64_t nh, int64_t act, double eps, int64_t seed,
                        int64_t t_attn, int64_t t_hidden, double inv_attn,
                        double inv_hidden, int64_t b0) {
  TORCH_CHECK(x0.dim() == 3 && flat0.size() == 16, "unirec_serve: lastq_fwd operands");
  const int dtype = DtypeCode(x0);
  const int B = x0.size(0), Lp = x0.size(1), D = x0.size(2), F = flat0[10].size(1);
  auto smem = reinterpret_cast<int (*)(int, int, int, int)>(
      Symbol("lastq_fwd", "unirec_lastq_fwd_smem_bytes"));
  TORCH_CHECK(D % nh == 0 && Lp % 8 == 0 && qi >= 0 && qi < Lp &&
                  smem(Lp, D, F, nh) <= kSmemLimit,
              "unirec_serve: last-query kernels do not take Lp=", Lp, ", D=", D, ", F=", F,
              ", nh=", nh, ", qi=", qi);
  const bool mma = reinterpret_cast<TakesFn>(
      Symbol("lastq_fwd", "unirec_lastq_fwd_mma_takes"))(dtype, Lp, D, F, nh) != 0;
  at::Tensor x = x0.contiguous(), madd = madd0.to(at::kFloat).contiguous();
  std::vector<at::Tensor> flat;
  for (const auto& t : flat0) flat.push_back(t.contiguous());
  if (mma) {
    x = Aligned16(x);
    madd = Aligned16(madd);
    for (int i : {0, 2, 4, 6, 10, 12}) flat[i] = Aligned16(flat[i]);
  }
  at::Tensor y = at::empty({B, D}, x.options());
  using Fn = int (*)(int, const void*, const void*, const void*, const void*, const void*,
                     const void*, const void*, const void*, const void*, const void*,
                     const void*, const void*, const void*, const void*, const void*,
                     const void*, const void*, const void*, void*, int, int, int, int, int,
                     int, int, int, float, unsigned, unsigned, unsigned, float, float,
                     unsigned, void*);
  auto fn = reinterpret_cast<Fn>(Symbol("lastq_fwd", "unirec_lastq_fwd"));
  void* stream = c10::cuda::getCurrentCUDAStream(x.device().index()).stream();
  CheckLaunch(fn(dtype, Ptr(x), Ptr(madd), Ptr(flat[0]), Ptr(flat[1]), Ptr(flat[2]),
                 Ptr(flat[3]), Ptr(flat[4]), Ptr(flat[5]), Ptr(flat[6]), Ptr(flat[7]),
                 Ptr(flat[8]), Ptr(flat[9]), Ptr(flat[10]), Ptr(flat[11]), Ptr(flat[12]),
                 Ptr(flat[13]), Ptr(flat[14]), Ptr(flat[15]), Ptr(y), B, Lp, D, F,
                 static_cast<int>(nh), static_cast<int>(qi), static_cast<int>(act),
                 mma ? 1 : 0, static_cast<float>(eps), static_cast<unsigned>(seed),
                 static_cast<unsigned>(t_attn), static_cast<unsigned>(t_hidden),
                 static_cast<float>(inv_attn), static_cast<float>(inv_hidden),
                 static_cast<unsigned>(b0), stream),
              "lastq_fwd");
  Launches()["unirec::lastq_fwd"] += 1;
  if (mma) Launches()["unirec::lastq_fwd (mma)"] += 1;
  return y;
}
#endif  // UNIREC_WITH_CUDA

// the operators this build implements, by the device they run on
std::set<std::string> Implemented(const std::string& device) {
#ifdef UNIREC_WITH_CUDA
  if (device == "cuda") return {"unirec::layer_fwd", "unirec::lastq_fwd"};
#endif
  (void)device;
  return {};
}

std::vector<std::string> Split(const std::string& s, char sep) {
  std::vector<std::string> out;
  std::stringstream ss(s);
  std::string item;
  while (std::getline(ss, item, sep))
    if (!item.empty()) out.push_back(item);
  return out;
}

}  // namespace

TORCH_LIBRARY(unirec, m) {
  for (const auto& s : kUnirecSchemas) m.def(s.schema);
}

#ifdef UNIREC_WITH_CUDA
TORCH_LIBRARY_IMPL(unirec, CUDA, m) {
  m.impl("layer_fwd", &LayerFwdCuda);
  m.impl("lastq_fwd", &LastqFwdCuda);
}
#endif

int main(int argc, char** argv) {
  std::vector<std::string> pos;
  int repeat = 1;
  bool schemas = false;
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    if (a == "--schemas") {
      schemas = true;
    } else if (a == "--repeat" && i + 1 < argc) {
      repeat = std::max(1, std::atoi(argv[++i]));
    } else if (a == "--lib" && i + 1 < argc) {
      std::string kv = argv[++i];
      size_t eq = kv.find('=');
      if (eq == std::string::npos) Die("--lib takes NAME=PATH, got " + kv, 2);
      void* h = dlopen(kv.substr(eq + 1).c_str(), RTLD_NOW | RTLD_LOCAL);
      if (h == nullptr) Die(std::string("dlopen: ") + dlerror());
      Libraries()[kv.substr(0, eq)] = h;
    } else {
      pos.push_back(a);
    }
  }
  if (schemas) {
    for (const auto& s : kUnirecSchemas) {
      auto op = c10::Dispatcher::singleton().findSchema(
          {std::string("unirec::") + s.name, ""});
      if (!op) Die(std::string("unirec::") + s.name + " is not registered");
      std::ostringstream os;
      os << op->schema();
      std::printf("schema %s\n", os.str().c_str());
    }
    return 0;
  }
  if (pos.size() != 3) {
    std::fprintf(stderr,
                 "usage: %s <package.pt2> <inputs.bin> <outputs.bin> [--lib NAME=PATH ...] "
                 "[--repeat N]\n       %s --schemas\n",
                 argv[0], argv[0]);
    return 2;
  }
  const std::string pkg = pos[0], in_path = pos[1], out_path = pos[2];

  // refuse, by name, a package whose operators this client does not run
  auto meta = torch::inductor::AOTIModelPackageLoader::load_metadata_from_package(pkg, "model");
  const std::string device = meta.count("AOTI_DEVICE_KEY") ? meta["AOTI_DEVICE_KEY"] : "cpu";
  const std::set<std::string> have = Implemented(device);
  for (const auto& op : Split(meta.count("unirec_ops") ? meta["unirec_ops"] : "", ',')) {
    if (!have.count(op)) {
      std::string list;
      for (const auto& h : have) list += (list.empty() ? "" : ", ") + h;
      Die("refusing " + pkg + ": it calls " + op + ", which this client does not implement on " +
              device + " (it implements: " + (list.empty() ? "none" : list) + ")",
          3);
    }
  }

  torch::inductor::AOTIModelPackageLoader loader(pkg);
  std::vector<at::Tensor> inputs;
  for (auto& t : ReadTensors(in_path)) inputs.push_back(t.to(at::Device(device)));
  std::vector<at::Tensor> outputs = loader.run(inputs);  // the first call, then timed ones
  auto sync = [&] {
#ifdef UNIREC_WITH_CUDA
    if (device == "cuda") c10::cuda::device_synchronize();
#endif
  };
  sync();
  auto t0 = std::chrono::steady_clock::now();
  for (int r = 0; r < repeat; ++r) outputs = loader.run(inputs);
  sync();
  double s = std::chrono::duration<double>(std::chrono::steady_clock::now() - t0).count();
  WriteTensors(out_path, outputs);
  std::printf("device %s\n", device.c_str());
  std::printf("seconds_per_call %.9f\n", s / repeat);
  std::printf("calls %d\n", repeat + 1);
  for (const auto& s2 : kUnirecSchemas) {
    const std::string q = std::string("unirec::") + s2.name;
    auto it = Launches().find(q);
    std::printf("launches %s %lld\n", q.c_str(),
                static_cast<long long>(it == Launches().end() ? 0 : it->second));
    auto mm = Launches().find(q + " (mma)");
    if (mm != Launches().end())
      std::printf("launches_mma %s %lld\n", q.c_str(), static_cast<long long>(mm->second));
  }
  std::fprintf(stderr, "unirec_serve: %zu outputs written to %s\n", outputs.size(),
               out_path.c_str());
  return 0;
}

// hess_server: the PyTorch/CUDA port's TCP feature server (own copy of
// csrc/hess_server.cpp).
//
// Architecture mirrors the reference ServerSiftGPU server loop
// (reference: src/ServerSiftGPU/ServerSiftGPU.cpp:239-530 + server.cpp):
// C++ owns the process, the listening socket, and the binary command
// protocol; the embedded CPython interpreter runs the compute through
// hessgpu_tpu_torch.server_backend.ServerBackend, on the card unless
// -device cpu is given. The wire protocol is command-compatible with the
// reference (same command IDs, same framing: raw little-endian ints,
// newline-terminated strings, SiftKeypoint = 6 x float32, descriptors =
// 128 x float32).
//
// Build: python -m hessgpu_tpu_torch.server_build   (prints the binary's path)
// Run:   hess_server -server 7777 [-device cpu|cuda] [sift params...]
// Test:  hess_server -test [-server PORT] [-device cpu|cuda]  (loopback)
//        hessgpu_tpu_torch/parallel/client.py provides the client.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <arpa/inet.h>
#include <limits.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

enum Command {
  COMMAND_NONE = 0,
  COMMAND_EXIT = 1,
  COMMAND_DISCONNECT,
  COMMAND_INITIALIZE,
  COMMAND_ALLOCATE_PYRAMID,
  COMMAND_RUNSIFT,
  COMMAND_RUNSIFT_FILE,
  COMMAND_RUNSIFT_KEY,
  COMMAND_RUNSIFT_DATA,
  COMMAND_SAVE_SIFT,
  COMMAND_SET_MAX_DIMENSION,
  COMMAND_SET_KEYPOINT,
  COMMAND_GET_FEATURE_COUNT,
  COMMAND_SET_TIGHTPYRAMID,
  COMMAND_GET_KEY_VECTOR,
  COMMAND_GET_DES_VECTOR,
  COMMAND_PARSE_PARAM,
  COMMAND_MATCH_INITIALIZE,
  COMMAND_MATCH_SET_LANGUAGE,
  COMMAND_MATCH_SET_DES_FLOAT,
  COMMAND_MATCH_SET_DES_BYTE,
  COMMAND_MATCH_SET_MAXSIFT,
  COMMAND_MATCH_GET_MATCH,
};

constexpr int kDefaultPort = 7777;

// ---------------------------------------------------------------------------
// socket helpers (framing identical to the reference SocketUtil)
// ---------------------------------------------------------------------------

bool ReadData(int fd, void* data, int count) {
  char* p = static_cast<char*>(data);
  int total = 0;
  while (total < count) {
    ssize_t n = recv(fd, p + total, count - total, 0);
    if (n <= 0) return false;
    total += static_cast<int>(n);
  }
  return true;
}

bool ReadInt(int fd, int* value, int count = 1) {
  return ReadData(fd, value, static_cast<int>(sizeof(int)) * count);
}

bool WriteInt(int fd, int value) {
  return send(fd, &value, sizeof(int), 0) == sizeof(int);
}

bool WriteData(int fd, const void* data, int count) {
  const char* p = static_cast<const char*>(data);
  int total = 0;
  while (total < count) {
    ssize_t n = send(fd, p + total, count - total, 0);
    if (n <= 0) return false;
    total += static_cast<int>(n);
  }
  return true;
}

// newline-terminated string; NULs mapped to spaces like the reference
int ReadLine(int fd, char* buf, int max_len) {
  char c;
  int n = 1;
  for (; n < max_len; ++n) {
    ssize_t num = recv(fd, &c, 1, 0);
    if (num == 1) {
      if (c == '\n') break;
      *buf++ = (c == 0) ? ' ' : c;
    } else if (num == 0) {
      if (n == 1) return 0;
      break;
    } else {
      return -1;
    }
  }
  *buf = 0;
  return n;
}

// ---------------------------------------------------------------------------
// embedded python backend
// ---------------------------------------------------------------------------

// Each connection thread owns one ServerBackend instance; every entry
// into the interpreter grabs the GIL (connection threads are plain C++
// threads, so PyGILState_Ensure is the correct primitive).
class GilLock {
 public:
  GilLock() : state_(PyGILState_Ensure()) {}
  ~GilLock() { PyGILState_Release(state_); }
  GilLock(const GilLock&) = delete;
  GilLock& operator=(const GilLock&) = delete;

 private:
  PyGILState_STATE state_;
};

class PyBackend {
 public:
  PyBackend(const std::string& params, const std::string& device) {
    GilLock gil;
    PyObject* module =
        PyImport_ImportModule("hessgpu_tpu_torch.server_backend");
    if (!module) {
      PyErr_Print();
      std::fprintf(stderr, "hess_server: cannot import hessgpu_tpu_torch\n");
      std::exit(1);
    }
    PyObject* cls = PyObject_GetAttrString(module, "ServerBackend");
    backend_ = PyObject_CallFunction(cls, "ss", params.c_str(),
                                     device.c_str());
    if (!backend_) {
      PyErr_Print();
      std::exit(1);
    }
    Py_DECREF(cls);
    Py_DECREF(module);
  }

  ~PyBackend() {
    GilLock gil;
    Py_XDECREF(backend_);
  }

  long CallInt(const char* method, const char* fmt = nullptr, ...) {
    GilLock gil;
    va_list va;
    PyObject* result;
    if (fmt) {
      va_start(va, fmt);
      PyObject* callable = PyObject_GetAttrString(backend_, method);
      PyObject* args = Py_VaBuildValue(fmt, va);
      va_end(va);
      result = PyObject_CallObject(callable, args);
      Py_XDECREF(args);
      Py_DECREF(callable);
    } else {
      result = PyObject_CallMethod(backend_, method, nullptr);
    }
    if (!result) {
      PyErr_Print();
      return 0;
    }
    long value = PyLong_Check(result) ? PyLong_AsLong(result) : 0;
    Py_DECREF(result);
    return value;
  }

  void CallVoid(const char* method, const char* fmt = nullptr, ...) {
    GilLock gil;
    PyObject* args = nullptr;
    if (fmt) {
      va_list va;
      va_start(va, fmt);
      args = Py_VaBuildValue(fmt, va);
      va_end(va);
    }
    PyObject* callable = PyObject_GetAttrString(backend_, method);
    PyObject* result = PyObject_CallObject(callable, args);
    if (!result) PyErr_Print();
    Py_XDECREF(result);
    Py_DECREF(callable);
    Py_XDECREF(args);
  }

  bool CallBytes(const char* method, std::vector<char>* out,
                 const char* fmt = nullptr, ...) {
    GilLock gil;
    PyObject* args = nullptr;
    if (fmt) {
      va_list va;
      va_start(va, fmt);
      args = Py_VaBuildValue(fmt, va);
      va_end(va);
    }
    PyObject* callable = PyObject_GetAttrString(backend_, method);
    PyObject* result = PyObject_CallObject(callable, args);
    Py_DECREF(callable);
    Py_XDECREF(args);
    if (!result) {
      PyErr_Print();
      return false;
    }
    char* buf = nullptr;
    Py_ssize_t len = 0;
    if (PyBytes_AsStringAndSize(result, &buf, &len) != 0) {
      Py_DECREF(result);
      return false;
    }
    out->assign(buf, buf + len);
    Py_DECREF(result);
    return true;
  }

 private:
  PyObject* backend_ = nullptr;
};

// ---------------------------------------------------------------------------
// the serving loop. The reference serves one connection at a time
// (ServerSiftGPU.cpp:239-530); here each client gets its own thread and
// its own ServerBackend instance, so per-connection state (current
// image, keypoint list, matcher slots, parse_param overrides) is
// isolated while the built kernels and the device are shared. The GIL
// serializes interpreter entry.
// ---------------------------------------------------------------------------

void ServeConnection(int fd, PyBackend* backend) {
  char buf[1024];
  int command = 0;
  int feature_count = 0;

  while (ReadInt(fd, &command) && command != COMMAND_DISCONNECT) {
    switch (command) {
      case COMMAND_INITIALIZE: {
        WriteInt(fd, static_cast<int>(backend->CallInt("initialize")));
        break;
      }
      case COMMAND_EXIT: {
        // shut the whole server down (reference semantics: the spawning
        // client terminates its server); _Exit avoids running dtors under
        // other threads' feet
        close(fd);
        std::fflush(nullptr);
        std::_Exit(0);
      }
      case COMMAND_ALLOCATE_PYRAMID: {
        int size[2];
        ReadInt(fd, size, 2);  // pyramid sizing is automatic
        break;
      }
      case COMMAND_RUNSIFT: {
        // re-run on the current image; consumes a pending COMMAND_SET_KEYPOINT
        // list if one was uploaded (reference ServerSiftGPU.cpp:334-346)
        int result = static_cast<int>(backend->CallInt("run_sift_current"));
        feature_count = static_cast<int>(backend->CallInt("feature_count"));
        WriteInt(fd, result);
        break;
      }
      case COMMAND_SET_KEYPOINT: {
        // upload a keypoint list for the next COMMAND_RUNSIFT; no reply
        // (reference ServerSiftGPU.cpp:362-377)
        int num = 0, has_orientation = 0;
        ReadInt(fd, &num);
        ReadInt(fd, &has_orientation);
        if (num > 0) {
          std::vector<char> keys(static_cast<size_t>(num) * 6 * sizeof(float));
          ReadData(fd, keys.data(), static_cast<int>(keys.size()));
          backend->CallVoid("set_keypoint_list", "(y#ii)", keys.data(),
                            static_cast<Py_ssize_t>(keys.size()), num,
                            has_orientation);
        }
        break;
      }
      case COMMAND_RUNSIFT_FILE: {
        ReadLine(fd, buf, sizeof(buf));
        int result = static_cast<int>(
            backend->CallInt("run_sift_file", "(s)", buf));
        feature_count = static_cast<int>(backend->CallInt("feature_count"));
        WriteInt(fd, result);
        break;
      }
      case COMMAND_RUNSIFT_DATA: {
        int desc[4], size = 0;
        ReadInt(fd, desc, 4);
        ReadInt(fd, &size, 1);
        std::vector<char> data(size);
        ReadData(fd, data.data(), size);
        int ok = static_cast<int>(backend->CallInt(
            "run_sift_data", "(iiy#ii)", desc[0], desc[1], data.data(),
            static_cast<Py_ssize_t>(size), desc[2], desc[3]));
        feature_count = static_cast<int>(backend->CallInt("feature_count"));
        WriteInt(fd, ok);
        break;
      }
      case COMMAND_RUNSIFT_KEY: {
        int num = 0, has_orientation = 0;
        ReadInt(fd, &num);
        ReadInt(fd, &has_orientation);
        int result = 0;
        if (num > 0) {
          std::vector<char> keys(num * 6 * sizeof(float));
          ReadData(fd, keys.data(), static_cast<int>(keys.size()));
          result = static_cast<int>(backend->CallInt(
              "run_sift_keys", "(y#ii)", keys.data(),
              static_cast<Py_ssize_t>(keys.size()), num, has_orientation));
          feature_count = static_cast<int>(backend->CallInt("feature_count"));
        }
        WriteInt(fd, result);
        break;
      }
      case COMMAND_GET_FEATURE_COUNT: {
        WriteInt(fd, feature_count);
        break;
      }
      case COMMAND_GET_KEY_VECTOR: {
        std::vector<char> bytes;
        backend->CallBytes("get_key_vector", &bytes);
        WriteData(fd, bytes.data(), static_cast<int>(bytes.size()));
        break;
      }
      case COMMAND_GET_DES_VECTOR: {
        std::vector<char> bytes;
        backend->CallBytes("get_des_vector", &bytes);
        WriteData(fd, bytes.data(), static_cast<int>(bytes.size()));
        break;
      }
      case COMMAND_SAVE_SIFT: {
        ReadLine(fd, buf, sizeof(buf));
        backend->CallVoid("save_sift", "(s)", buf);
        break;
      }
      case COMMAND_SET_MAX_DIMENSION: {
        int maxd = 0;
        if (ReadInt(fd, &maxd) && maxd > 0) {
          backend->CallVoid("set_max_dimension", "(i)", maxd);
        }
        break;
      }
      case COMMAND_SET_TIGHTPYRAMID: {
        int tight = 0;
        ReadInt(fd, &tight);  // buffers come from the caching allocator
        break;
      }
      case COMMAND_PARSE_PARAM: {
        ReadLine(fd, buf, sizeof(buf));
        backend->CallVoid("parse_param", "(s)", buf);
        break;
      }
      case COMMAND_MATCH_INITIALIZE: {
        WriteInt(fd, 1);
        break;
      }
      case COMMAND_MATCH_SET_LANGUAGE: {
        int language = 0;
        ReadInt(fd, &language);  // one matcher backend
        break;
      }
      case COMMAND_MATCH_SET_DES_FLOAT:
      case COMMAND_MATCH_SET_DES_BYTE: {
        int cmd3[3] = {0, 0, 0};
        if (ReadData(fd, cmd3, sizeof(cmd3))) {
          const bool is_float = command == COMMAND_MATCH_SET_DES_FLOAT;
          const size_t elt = is_float ? sizeof(float) : 1;
          std::vector<char> data(128 * elt * cmd3[1]);
          if (ReadData(fd, data.data(), static_cast<int>(data.size()))) {
            backend->CallVoid(is_float ? "match_set_descriptors_float"
                                       : "match_set_descriptors_byte",
                              "(iiy#)", cmd3[0], cmd3[1], data.data(),
                              static_cast<Py_ssize_t>(data.size()));
          }
        }
        break;
      }
      case COMMAND_MATCH_GET_MATCH: {
        int cmd2[2];
        float fcmd2[2];
        int result = 0;
        std::vector<char> bytes;
        if (ReadData(fd, cmd2, sizeof(cmd2)) &&
            ReadData(fd, fcmd2, sizeof(fcmd2))) {
          if (backend->CallBytes("match_get_match", &bytes, "(iffi)",
                                 cmd2[0], static_cast<double>(fcmd2[0]),
                                 static_cast<double>(fcmd2[1]), cmd2[1])) {
            result = static_cast<int>(bytes.size() / (2 * sizeof(int)));
          }
        }
        WriteInt(fd, result);
        if (result > 0) {
          WriteData(fd, bytes.data(), result * 2 * sizeof(int));
        }
        break;
      }
      case COMMAND_MATCH_SET_MAXSIFT: {
        int max_sift = 0;
        if (ReadInt(fd, &max_sift)) {
          backend->CallVoid("match_set_maxsift", "(i)", max_sift);
        }
        break;
      }
      default:
        std::fprintf(stderr, "hess_server: unrecognized command %d\n",
                     command);
        break;
    }
  }
  close(fd);
}

}  // namespace

// The embedded interpreter: the one the server was built for (its
// executable's path is compiled in, so a virtual environment's packages are
// found), with the repository root - three levels above this source - and
// the working directory on sys.path.
#ifndef HESS_PYTHON_EXECUTABLE
#define HESS_PYTHON_EXECUTABLE "python3"
#endif

static void StartPython() {
  PyConfig config;
  PyConfig_InitPythonConfig(&config);
  PyStatus status = PyConfig_SetBytesString(&config, &config.program_name,
                                            HESS_PYTHON_EXECUTABLE);
  if (!PyStatus_Exception(status)) status = Py_InitializeFromConfig(&config);
  PyConfig_Clear(&config);
  if (PyStatus_Exception(status)) Py_ExitStatusException(status);
  PyRun_SimpleString(
      "import faulthandler, os, sys\n"
      "faulthandler.enable()\n"
      "sys.path.insert(0, os.getcwd())\n"
      "root = os.path.dirname(os.path.dirname(os.path.dirname("
      "os.path.abspath('" __FILE__ "'))))\n"
      "sys.path.insert(0, root)\n");
}

// -test / -test_remote loopback self-tests (reference server.cpp:31-60):
// the binary already embeds CPython, so the test client is the port's
// RemoteSift driven in-process. -test spawns this very binary
// (/proc/self/exe) as the local server, with the same -device; -test_remote
// connects to a named host. Two seeded 320x240 frames are detected and
// matched over the wire.
static int RunSelfTest(const char* host, int port, const std::string& params,
                       const std::string& device) {
  char self[PATH_MAX] = {0};
  if (realpath("/proc/self/exe", self) == nullptr) {
    std::perror("hess_server: /proc/self/exe");
    return 1;
  }
  StartPython();
  std::string code =
      "import numpy as np\n"
      "from hessgpu_tpu_torch.parallel.client import RemoteSift\n"
      "from hessgpu_tpu_torch.sfm.synthetic import texture_frame\n"
      "host = " + (host ? ("'" + std::string(host) + "'") : std::string("None")) + "\n"
      "port = " + std::to_string(port) + "\n"
      "params = '''" + params + "'''\n"
      "with RemoteSift(host=host, port=port, server_binary='" + self + "',\n"
      "                spawn_args=['-device', '" + device + "']) as r:\n"
      "    assert r.initialize(), 'init failed'\n"
      "    if params.strip(): r.parse_param(params.strip())\n"
      "    desc = []\n"
      "    for seed in (0, 1):\n"
      "        img = (texture_frame(seed, 240, 320) * 255 + 0.5)\n"
      "        img = img.astype(np.uint8)\n"
      "        ok = r.run_sift_data(img)\n"
      "        n = r.get_feature_count()\n"
      "        print('texture_frame(%d): ok=%s features=%d' % (seed, ok, n),\n"
      "              flush=True)\n"
      "        assert ok and n > 0\n"
      "        desc.append(r.get_feature_vector()[1])\n"
      "    r.match_set_descriptors(0, desc[0])\n"
      "    r.match_set_descriptors(1, desc[0])\n"
      "    m = r.match()\n"
      "    print('self-match: %d of %d' % (len(m), len(desc[0])), flush=True)\n"
      "    assert len(m) > 0\n"
      "print('hess_server self-test passed', flush=True)\n";
  int rc = PyRun_SimpleString(code.c_str());
  Py_Finalize();
  return rc == 0 ? 0 : 1;
}

int main(int argc, char** argv) {
  int port = kDefaultPort;
  std::string params;
  std::string device = "cuda";
  bool test_local = false;
  const char* test_host = nullptr;
  for (int i = 1; i < argc; ++i) {
    if (std::strcmp(argv[i], "-server") == 0 && i + 1 < argc) {
      port = std::atoi(argv[++i]);
    } else if (std::strcmp(argv[i], "-device") == 0 && i + 1 < argc) {
      device = argv[++i];
    } else if (std::strcmp(argv[i], "-test") == 0) {
      test_local = true;
    } else if (std::strcmp(argv[i], "-test_remote") == 0 && i + 2 < argc) {
      test_host = argv[++i];
      port = std::atoi(argv[++i]);
    } else {
      if (!params.empty()) params += ' ';
      params += argv[i];
    }
  }
  if (device != "cpu" && device != "cuda") {
    std::fprintf(stderr, "hess_server: -device must be cpu or cuda, not %s\n",
                 device.c_str());
    return 2;
  }
  if (test_local || test_host)
    return RunSelfTest(test_host, port, params, device);

  StartPython();
  // import the port, initialise CUDA and load the kernels here, on the main
  // thread before any connection: CUDA's first initialisation in a
  // connection thread crashed the process now and then (SIGSEGV)
  {
    PyObject* module =
        PyImport_ImportModule("hessgpu_tpu_torch.server_backend");
    PyObject* ready = module ? PyObject_CallMethod(module, "prepare", "s",
                                                   device.c_str())
                             : nullptr;
    if (!ready) {
      PyErr_Print();
      std::fprintf(stderr, "hess_server: cannot prepare the backend\n");
      return 1;
    }
    Py_DECREF(ready);
    Py_DECREF(module);
  }

  int sockfd = socket(AF_INET, SOCK_STREAM, 0);
  int opt = 1;
  setsockopt(sockfd, SOL_SOCKET, SO_REUSEADDR, &opt, sizeof(opt));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(sockfd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    std::perror("hess_server: bind");
    return 1;
  }
  if (listen(sockfd, 8) != 0) {
    std::perror("hess_server: listen");
    return 1;
  }
  std::printf("hess_server: listening on port %d (device %s)\n", port,
              device.c_str());
  std::fflush(stdout);

  // hand the GIL over to connection threads; main only accepts
  PyThreadState* main_state = PyEval_SaveThread();

  for (;;) {
    sockaddr_in cli{};
    socklen_t len = sizeof(cli);
    int fd = accept(sockfd, reinterpret_cast<sockaddr*>(&cli), &len);
    if (fd < 0) break;
    std::printf("hess_server: client connected\n");
    std::fflush(stdout);
    std::thread([fd, params, device]() {
      PyBackend backend(params, device);
      ServeConnection(fd, &backend);
      std::printf("hess_server: client disconnected\n");
      std::fflush(stdout);
    }).detach();
  }
  close(sockfd);
  PyEval_RestoreThread(main_state);
  Py_Finalize();
  return 0;
}

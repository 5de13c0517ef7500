// Elastic training coordinator — C++ TCP service.
//
// Role parity with the reference's Go master (go/master/service.go):
//   * dataset partitioned into task chunks (SetDataset, partition :105)
//   * four task queues: todo / pending / done / failed (:80-84)
//   * GetTask dispatch with per-task deadline timers (:362, checkTimeoutFunc :336)
//   * TaskFinished / TaskFailed with a failure cap discarding poison tasks
//     (:404, :442, processFailedTask :308)
//   * pass rollover when todo+pending drain (:all done -> new pass)
//   * state snapshot/recovery to a durable file (snapshot :201, recover :165;
//     file store here = the inmem_store/etcd Store role)
//   * save-model election: exactly one worker wins per interval
//     (RequestSaveModel :468)
//   * worker membership with leases (pserver etcd_client.go Register parity)
//
// Design differences from the reference (deliberate): gradient exchange
// is NOT here — torch.distributed collectives (NCCL, gloo) own it. The
// coordinator only owns work dispatch + liveness + election, i.e. the part
// of the Go runtime whose state must outlive accelerators. Protocol is
// newline-delimited JSON over TCP (one request per line, one response per
// line) instead of Go net/rpc; a ~zero-dependency wire format every client
// (Python ctypes-free socket, C, shell) can speak.
//
// Build: g++ -O2 -std=c++17 -pthread -o coordinator coordinator.cc (the
//        client, paddle_tpu_torch/distributed/client.py, builds it at
//        first use into paddle_tpu_torch/build/)
// Run:   coordinator <port> [snapshot_path] [task_timeout] [failure_max]

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <fstream>
#include <map>
#include <mutex>
#include <set>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

double now_sec() {
  return std::chrono::duration<double>(Clock::now().time_since_epoch()).count();
}

// ---------------------------------------------------------------------------
// Minimal JSON: we only need flat objects with string/number/array-of-string
// values. Hand-rolled to keep the binary dependency-free.
// ---------------------------------------------------------------------------
std::string json_escape(const std::string& s) {
  std::string out;
  for (char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\t': out += "\\t"; break;
      case '\r': out += "\\r"; break;
      default:
        if ((unsigned char)c < 0x20) {  // remaining control chars
          char buf[8];
          snprintf(buf, sizeof(buf), "\\u%04x", (unsigned)(unsigned char)c);
          out += buf;
        } else {
          out += c;
        }
    }
  }
  return out;
}

// Advance i past a quoted JSON string (i at the opening quote on entry, one
// past the closing quote on exit), honoring backslash escapes. Structural
// scanners MUST use this: depth counting over raw characters miscounts
// braces/brackets that appear inside string values (hostile task names).
void skip_json_string(const std::string& s, size_t& i) {
  i++;  // opening quote
  while (i < s.size()) {
    if (s[i] == '\\') { i += 2; continue; }
    if (s[i] == '"') { i++; return; }
    i++;
  }
}

struct JsonValue {
  std::string str;
  double num = 0;
  std::vector<std::string> arr;
  bool is_num = false;
  bool is_arr = false;
};

// parse {"k": "v", "k2": 3, "k3": ["a","b"]}; tolerant, flat only.
std::map<std::string, JsonValue> parse_json(const std::string& line) {
  std::map<std::string, JsonValue> out;
  size_t i = 0;
  auto skip_ws = [&] { while (i < line.size() && isspace(line[i])) i++; };
  auto parse_string = [&]() -> std::string {
    std::string s;
    i++;  // opening quote
    while (i < line.size() && line[i] != '"') {
      if (line[i] == '\\' && i + 1 < line.size()) {
        i++;
        switch (line[i]) {
          case 'n': s += '\n'; break;
          case 't': s += '\t'; break;
          case 'r': s += '\r'; break;
          case 'u': {  // \uXXXX (Python json.dumps default ensure_ascii)
            if (i + 4 < line.size()) {
              unsigned code = (unsigned)strtoul(
                  line.substr(i + 1, 4).c_str(), nullptr, 16);
              i += 4;
              // encode UTF-8 (BMP only; surrogate pairs unsupported — the
              // client can send ensure_ascii=False for astral chars)
              if (code < 0x80) {
                s += (char)code;
              } else if (code < 0x800) {
                s += (char)(0xC0 | (code >> 6));
                s += (char)(0x80 | (code & 0x3F));
              } else {
                s += (char)(0xE0 | (code >> 12));
                s += (char)(0x80 | ((code >> 6) & 0x3F));
                s += (char)(0x80 | (code & 0x3F));
              }
            }
            break;
          }
          default: s += line[i];
        }
      } else {
        s += line[i];
      }
      i++;
    }
    i++;  // closing quote
    return s;
  };
  skip_ws();
  if (i >= line.size() || line[i] != '{') return out;
  i++;
  while (i < line.size()) {
    skip_ws();
    if (i < line.size() && line[i] == '}') break;
    if (line[i] != '"') break;
    std::string key = parse_string();
    skip_ws();
    if (i < line.size() && line[i] == ':') i++;
    skip_ws();
    JsonValue v;
    if (i < line.size() && line[i] == '"') {
      v.str = parse_string();
    } else if (i < line.size() && line[i] == '[') {
      v.is_arr = true;
      i++;
      while (i < line.size() && line[i] != ']') {
        skip_ws();
        if (line[i] == '"') v.arr.push_back(parse_string());
        else i++;
        skip_ws();
        if (i < line.size() && line[i] == ',') i++;
      }
      i++;
    } else {
      size_t start = i;
      while (i < line.size() && (isdigit(line[i]) || line[i] == '-' ||
                                 line[i] == '+' || line[i] == '.' ||
                                 line[i] == 'e' || line[i] == 'E'))
        i++;
      v.is_num = true;
      v.num = atof(line.substr(start, i - start).c_str());
    }
    out[key] = v;
    skip_ws();
    if (i < line.size() && line[i] == ',') i++;
  }
  return out;
}

// ---------------------------------------------------------------------------
// Task state (go/master/service.go taskQueues parity)
// ---------------------------------------------------------------------------
struct Task {
  int64_t id = 0;
  std::vector<std::string> chunks;  // shard paths / spec strings
  int failures = 0;                 // processFailedTask cap
  double deadline = 0;              // pending timeout
  std::string owner;
};

struct SaveLease {
  std::string owner;
  double expires = 0;
};

class Service {
 public:
  Service(double task_timeout, int failure_max, std::string snapshot_path)
      : task_timeout_(task_timeout),
        failure_max_(failure_max),
        snapshot_path_(std::move(snapshot_path)) {
    recover();
  }

  std::string handle(const std::string& line) {
    auto req = parse_json(line);
    const std::string op = req["op"].str;
    std::lock_guard<std::mutex> lock(mu_);
    if (op == "set_dataset") return set_dataset(req);
    if (op == "get_task") return get_task(req);
    if (op == "task_finished") return task_finished(req);
    if (op == "task_failed") return task_failed(req);
    if (op == "heartbeat") return heartbeat(req);
    if (op == "register") return register_worker(req);
    if (op == "workers") return list_workers();
    if (op == "fleet_stats") return fleet_stats();
    if (op == "serve_hosts") return serve_hosts();
    if (op == "request_save_model") return request_save_model(req);
    if (op == "status") return status();
    if (op == "snapshot") { snapshot(); return R"({"ok": true})"; }
    return R"({"ok": false, "error": "unknown op"})";
  }

  void tick() {  // timeout scanner (checkTimeoutFunc parity)
    std::lock_guard<std::mutex> lock(mu_);
    double t = now_sec();
    for (auto it = pending_.begin(); it != pending_.end();) {
      if (it->second.deadline < t) {
        Task task = it->second;
        it = pending_.erase(it);
        task.owner.clear();
        task.failures++;  // timeouts count toward the poison cap (:336→:308)
        if (task.failures >= failure_max_) failed_.push_back(task);
        else todo_.push_back(task);
        dirty_ = true;
      } else {
        ++it;
      }
    }
    // expire worker leases (and their serving metadata with them: a
    // lapsed lease IS the death signal the serving front keys off)
    for (auto it = workers_.begin(); it != workers_.end();) {
      if (it->second < t) {
        meta_.erase(it->first);
        it = workers_.erase(it);
      } else {
        ++it;
      }
    }
    if (dirty_) { snapshot(); dirty_ = false; }
  }

 private:
  std::string set_dataset(std::map<std::string, JsonValue>& req) {
    // partition chunks into tasks (partition :105)
    int per_task = req.count("chunks_per_task")
                       ? (int)req["chunks_per_task"].num : 8;
    if (per_task < 1) per_task = 1;
    auto& chunks = req["chunks"].arr;
    todo_.clear(); pending_.clear(); done_.clear(); failed_.clear();
    int64_t id = 0;
    for (size_t i = 0; i < chunks.size(); i += per_task) {
      Task t;
      t.id = next_task_id_++;
      for (size_t j = i; j < i + per_task && j < chunks.size(); j++)
        t.chunks.push_back(chunks[j]);
      todo_.push_back(t);
      id++;
    }
    pass_ = 0;
    dirty_ = true;
    char buf[64];
    snprintf(buf, sizeof buf, "{\"ok\": true, \"num_tasks\": %lld}",
             (long long)id);
    return buf;
  }

  std::string get_task(std::map<std::string, JsonValue>& req) {
    // pass-scoped dispatch (go/master ErrPassAfter/ErrAllTaskFinished
    // parity): a worker asking for pass p gets "pass done" once the queues
    // roll over, instead of silently being fed the next pass's tasks.
    int want = req.count("pass") ? (int)req["pass"].num : -1;
    auto pass_done = [&]() {
      std::ostringstream os;
      os << "{\"ok\": false, \"error\": \"pass done\", \"pass\": " << pass_
         << "}";
      return os.str();
    };
    if (want >= 0 && pass_ > want) return pass_done();
    if (todo_.empty() && pending_.empty()) {
      if (!done_.empty()) {  // pass rollover (all done -> next pass)
        for (auto& t : done_) { t.failures = 0; todo_.push_back(t); }
        done_.clear();
        pass_++;
        dirty_ = true;
        if (want >= 0) return pass_done();
      } else {
        return R"({"ok": false, "error": "no more tasks"})";
      }
    }
    if (todo_.empty())
      return R"({"ok": false, "error": "all tasks pending", "retry": 1})";
    Task t = todo_.front();
    todo_.pop_front();
    t.deadline = now_sec() + task_timeout_;
    t.owner = req["worker"].str;
    pending_[t.id] = t;
    dirty_ = true;
    std::ostringstream os;
    os << "{\"ok\": true, \"task_id\": " << t.id << ", \"pass\": " << pass_
       << ", \"chunks\": [";
    for (size_t i = 0; i < t.chunks.size(); i++) {
      if (i) os << ", ";
      os << '"' << json_escape(t.chunks[i]) << '"';
    }
    os << "]}";
    return os.str();
  }

  std::string task_finished(std::map<std::string, JsonValue>& req) {
    int64_t id = (int64_t)req["task_id"].num;
    auto it = pending_.find(id);
    if (it == pending_.end())
      return R"({"ok": false, "error": "task not pending"})";
    done_.push_back(it->second);
    pending_.erase(it);
    dirty_ = true;
    return R"({"ok": true})";
  }

  std::string task_failed(std::map<std::string, JsonValue>& req) {
    int64_t id = (int64_t)req["task_id"].num;
    auto it = pending_.find(id);
    if (it == pending_.end())
      return R"({"ok": false, "error": "task not pending"})";
    Task t = it->second;
    pending_.erase(it);
    t.failures++;
    t.owner.clear();
    if (t.failures >= failure_max_) {
      failed_.push_back(t);  // poison task discarded (:308)
    } else {
      todo_.push_back(t);
    }
    dirty_ = true;
    return R"({"ok": true})";
  }

  std::string register_worker(std::map<std::string, JsonValue>& req) {
    double ttl = req.count("ttl") ? req["ttl"].num : 30.0;
    workers_[req["worker"].str] = now_sec() + ttl;
    // optional flat metadata string (serving hosts announce their
    // dial address here, "kind=serve,addr=HOST:PORT"); re-sent on
    // every heartbeat so a coordinator restart re-learns it
    if (req.count("meta") && !req["meta"].str.empty())
      meta_[req["worker"].str] = req["meta"].str;
    std::ostringstream os;
    os << "{\"ok\": true, \"num_workers\": " << workers_.size() << "}";
    return os.str();
  }

  std::string heartbeat(std::map<std::string, JsonValue>& req) {
    return register_worker(req);
  }

  std::string list_workers() {
    std::ostringstream os;
    os << "{\"ok\": true, \"workers\": [";
    bool first = true;
    for (auto& kv : workers_) {
      if (!first) os << ", ";
      os << '"' << json_escape(kv.first) << '"';
      first = false;
    }
    os << "]}";
    return os.str();
  }

  std::string fleet_stats() {
    // live training-fleet membership with per-lease time-to-expiry —
    // the observability verb behind `cli observe --fleet-stats`
    // (observe/trainview.py): "who is alive RIGHT NOW and how stale is
    // each lease", where the steplog timeline only answers "what
    // happened". Negative lease_remaining = lapsed but not yet swept
    // by tick().
    double t = now_sec();
    std::ostringstream os;
    os << "{\"ok\": true, \"now\": " << t << ", \"workers\": [";
    bool first = true;
    for (auto& kv : workers_) {
      if (!first) os << ", ";
      os << "{\"id\": \"" << json_escape(kv.first)
         << "\", \"lease_remaining\": " << (kv.second - t);
      auto m = meta_.find(kv.first);
      if (m != meta_.end())
        os << ", \"meta\": \"" << json_escape(m->second) << "\"";
      os << "}";
      first = false;
    }
    os << "]}";
    return os.str();
  }

  std::string serve_hosts() {
    // serving-host membership: the workers that registered with
    // metadata (cli serve --join) — what the fleet-of-fleets front
    // polls to build its routing ring (serve/cluster.py). Same lease
    // semantics as fleet_stats; hosts without metadata (trainers)
    // are excluded.
    double t = now_sec();
    std::ostringstream os;
    os << "{\"ok\": true, \"now\": " << t << ", \"hosts\": [";
    bool first = true;
    for (auto& kv : workers_) {
      auto m = meta_.find(kv.first);
      if (m == meta_.end()) continue;
      if (!first) os << ", ";
      os << "{\"id\": \"" << json_escape(kv.first)
         << "\", \"lease_remaining\": " << (kv.second - t)
         << ", \"meta\": \"" << json_escape(m->second) << "\"}";
      first = false;
    }
    os << "]}";
    return os.str();
  }

  std::string request_save_model(std::map<std::string, JsonValue>& req) {
    // exactly-one-winner election per interval (RequestSaveModel :468)
    double t = now_sec();
    double ttl = req.count("ttl") ? req["ttl"].num : 60.0;
    const std::string& who = req["worker"].str;
    if (save_lease_.expires < t || save_lease_.owner == who) {
      save_lease_.owner = who;
      save_lease_.expires = t + ttl;
      return R"({"ok": true, "elected": true})";
    }
    return R"({"ok": true, "elected": false})";
  }

  std::string status() {
    std::ostringstream os;
    os << "{\"ok\": true, \"pass\": " << pass_
       << ", \"todo\": " << todo_.size()
       << ", \"pending\": " << pending_.size()
       << ", \"done\": " << done_.size()
       << ", \"failed\": " << failed_.size()
       << ", \"workers\": " << workers_.size() << "}";
    return os.str();
  }

  // ---- durable snapshot (snapshot :201 / recover :165) -------------------
  void write_tasks(std::ostream& os, const std::deque<Task>& q) {
    bool first = true;
    for (auto& t : q) {
      if (!first) os << ", ";
      first = false;
      os << "{\"id\": " << t.id << ", \"failures\": " << t.failures
         << ", \"chunks\": [";
      for (size_t i = 0; i < t.chunks.size(); i++) {
        if (i) os << ", ";
        os << '"' << json_escape(t.chunks[i]) << '"';
      }
      os << "]}";
    }
  }

  void snapshot() {
    if (snapshot_path_.empty()) return;
    std::string tmp = snapshot_path_ + ".tmp";
    {
      std::ofstream f(tmp);
      f << "{\"pass\": " << pass_ << ", \"next_task_id\": " << next_task_id_
        << ", \"todo\": [";
      // pending tasks are requeued as todo on recovery (workers lost)
      std::deque<Task> all = todo_;
      for (auto& kv : pending_) all.push_back(kv.second);
      write_tasks(f, all);
      f << "], \"done\": [";
      write_tasks(f, done_);
      f << "], \"failed\": [";
      write_tasks(f, failed_);
      // completeness marker, written LAST: recovery refuses any file
      // without it (go/pserver checkpoints carried an MD5 for the same
      // reason — detect external truncation/corruption, service.go:104)
      f << "], \"eof\": 1}\n";
    }
    rename(tmp.c_str(), snapshot_path_.c_str());
  }

  void recover() {
    if (snapshot_path_.empty()) return;
    std::ifstream f(snapshot_path_);
    if (!f.good()) return;
    std::string content((std::istreambuf_iterator<char>(f)),
                        std::istreambuf_iterator<char>());
    // Nested parse, string-aware: keys are matched only at the top level
    // of the snapshot object and every depth count skips quoted strings,
    // so task names containing quotes/braces/brackets round-trip intact.
    auto load_queue = [&](const std::string& key, std::deque<Task>* out) {
      // locate `"key"` at object depth 1, outside any string
      size_t i = 0;
      int depth = 0;
      size_t open = std::string::npos;
      while (i < content.size()) {
        char c = content[i];
        if (c == '"') {
          size_t start = i;
          skip_json_string(content, i);
          if (depth == 1 &&
              content.compare(start, key.size() + 2,
                              "\"" + key + "\"") == 0) {
            size_t j = i;
            while (j < content.size() && isspace(content[j])) j++;
            if (j < content.size() && content[j] == ':') {
              j++;
              while (j < content.size() && isspace(content[j])) j++;
              if (j < content.size() && content[j] == '[') {
                open = j;
                break;
              }
            }
          }
          continue;
        }
        if (c == '{' || c == '[') depth++;
        if (c == '}' || c == ']') depth--;
        i++;
      }
      if (open == std::string::npos) return;
      // extract the balanced [...] body, skipping strings
      size_t end = open;
      int d = 0;
      for (size_t p = open; p < content.size();) {
        char c = content[p];
        if (c == '"') { skip_json_string(content, p); continue; }
        if (c == '[' || c == '{') d++;
        if (c == ']' || c == '}') { d--; if (!d) { end = p; break; } }
        p++;
      }
      std::string body = content.substr(open + 1, end - open - 1);
      // split task objects at depth 0 of the body, string-aware
      size_t pos = 0;
      while (pos < body.size()) {
        while (pos < body.size() && body[pos] != '{') {
          if (body[pos] == '"') skip_json_string(body, pos);
          else pos++;
        }
        if (pos >= body.size()) break;
        size_t j = pos;
        int dd = 0;
        while (j < body.size()) {
          char c = body[j];
          if (c == '"') { skip_json_string(body, j); continue; }
          if (c == '{') dd++;
          if (c == '}') { dd--; if (!dd) break; }
          j++;
        }
        auto obj = parse_json(body.substr(pos, j - pos + 1));
        Task t;
        t.id = (int64_t)obj["id"].num;
        t.failures = (int)obj["failures"].num;
        t.chunks = obj["chunks"].arr;
        out->push_back(t);
        pos = j + 1;
      }
    };
    // a malformed snapshot (external truncation/corruption — our own
    // writes are tmp+rename atomic) must fail the start CLEANLY, like
    // go/master's recover returning an error — neither std::terminate via
    // an uncaught parser exception NOR a silent lenient parse that drops
    // queued tasks. The "eof" marker is written last, so its absence
    // proves the file is not a complete snapshot.
    // legacy pre-marker snapshots ended in exactly "]}\n" (or "]}"), which
    // truncation cannot produce — accept those so an upgrade restart does
    // not discard intact state
    bool legacy_complete = false;
    {
      std::string trimmed = content;
      while (!trimmed.empty() &&
             isspace((unsigned char)trimmed.back())) trimmed.pop_back();
      legacy_complete = trimmed.size() >= 2 &&
                        trimmed.compare(trimmed.size() - 2, 2, "]}") == 0;
    }
    if (content.find("\"eof\"") == std::string::npos && !legacy_complete) {
      fprintf(stderr,
              "[coordinator] FATAL: snapshot %s has no completeness marker "
              "(truncated or foreign file); refusing to start with partial "
              "state — repair or remove the file\n", snapshot_path_.c_str());
      exit(1);
    }
    try {
      auto top = parse_json(content);
      pass_ = (int)top["pass"].num;
      next_task_id_ = (int64_t)top["next_task_id"].num;
      if (next_task_id_ < 1) next_task_id_ = 1;
      load_queue("todo", &todo_);
      load_queue("done", &done_);
      load_queue("failed", &failed_);
    } catch (const std::exception& e) {
      fprintf(stderr,
              "[coordinator] FATAL: snapshot %s is unreadable (%s); refusing "
              "to start with partial state — repair or remove the file\n",
              snapshot_path_.c_str(), e.what());
      exit(1);
    }
    fprintf(stderr, "[coordinator] recovered: pass=%d todo=%zu done=%zu\n",
            pass_, todo_.size(), done_.size());
  }

  std::mutex mu_;
  std::deque<Task> todo_, done_, failed_;
  std::map<int64_t, Task> pending_;
  std::map<std::string, double> workers_;  // worker -> lease expiry
  std::map<std::string, std::string> meta_;  // worker -> serving metadata
  SaveLease save_lease_;
  int64_t next_task_id_ = 1;
  int pass_ = 0;
  double task_timeout_;
  int failure_max_;
  bool dirty_ = false;
  std::string snapshot_path_;
};

void serve_conn(int fd, Service* svc) {
  std::string buf;
  char chunk[4096];
  for (;;) {
    ssize_t n = read(fd, chunk, sizeof chunk);
    if (n <= 0) break;
    buf.append(chunk, n);
    size_t nl;
    while ((nl = buf.find('\n')) != std::string::npos) {
      std::string line = buf.substr(0, nl);
      buf.erase(0, nl + 1);
      if (line.empty()) continue;
      std::string resp = svc->handle(line) + "\n";
      size_t off = 0;
      while (off < resp.size()) {
        ssize_t w = write(fd, resp.data() + off, resp.size() - off);
        if (w <= 0) { close(fd); return; }
        off += w;
      }
    }
  }
  close(fd);
}

}  // namespace

int main(int argc, char** argv) {
  int port = argc > 1 ? atoi(argv[1]) : 8650;
  std::string snap = argc > 2 ? argv[2] : "";
  double timeout = argc > 3 ? atof(argv[3]) : 600.0;
  int failure_max = argc > 4 ? atoi(argv[4]) : 3;

  Service svc(timeout, failure_max, snap);

  int listener = socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(listener, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(port);
  if (bind(listener, (sockaddr*)&addr, sizeof addr) != 0) {
    perror("bind");
    return 1;
  }
  listen(listener, 64);
  fprintf(stderr, "[coordinator] listening on 127.0.0.1:%d\n", port);
  fflush(stderr);

  std::thread ticker([&svc] {
    for (;;) {
      std::this_thread::sleep_for(std::chrono::milliseconds(200));
      svc.tick();
    }
  });
  ticker.detach();

  for (;;) {
    int fd = accept(listener, nullptr, nullptr);
    if (fd < 0) continue;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    std::thread(serve_conn, fd, &svc).detach();
  }
}

// swarmdb_tpu_torch native broker — C++ partitioned durable log.
//
// The port's own copy of swarmdb_tpu/broker/cpp/broker.cpp, built at first
// use by broker/native.py. The on-disk format (record framing, the .off
// sidecars, meta files, the offsets log) and the C API are the JAX
// package's, byte for byte. One difference: topic names starting with "__"
// are accepted, except the offsets log's own "__offsets__" prefix, so the
// HA epoch topic "__swarmdb_ha" can live in a native log (the JAX copy
// refuses every "__" name). This replaces librdkafka plus an external
// Kafka deployment with an in-tree, in-process engine:
//
//   - topic -> N partitions, each an append-only log file
//     (<dir>/<topic>/<part>.log) with framed records, rebuilt into an
//     in-memory index on open (crash recovery = sequential scan, torn
//     tails truncated);
//   - contiguous offsets per partition; begin/end offsets; retention trim
//     (logical head advance; file truncated when fully trimmed);
//   - consumer-group committed offsets in an append-only offsets log,
//     compacted on open;
//   - wait_for_data via per-partition condition variables (the blocking
//     poll the Python Consumer uses);
//   - group-commit durability: a background flusher thread fsyncs dirty
//     partitions every sync_interval_ms and advances a per-partition
//     synced_offset; producers defer delivery reports until their record's
//     offset is below synced_offset (the `acks=all` durability point:
//     a DELIVERED report implies the record survives a crash);
//   - flush() = immediate fsync of every dirty fd + synced_offset advance.
//
// Exposed as a flat C API for ctypes (no pybind11 in this image).
// Threading: a shared_mutex over the topic map; one mutex+condvar per
// partition; offsets under their own mutex. All public entry points are
// thread-safe.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <shared_mutex>
#include <string>
#include <thread>
#include <vector>

#include <dirent.h>
#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x53574252;  // "SWBR"

#pragma pack(push, 1)
struct RecordHeader {
  uint32_t magic;
  int64_t offset;
  double timestamp;
  int32_t key_len;  // -1 => null key
  int32_t val_len;
};
#pragma pack(pop)

struct RecordMeta {
  int64_t offset;
  double timestamp;
  uint64_t pos;  // file position of the RecordHeader
  int32_t key_len;
  int32_t val_len;
};

struct Partition {
  std::mutex mu;
  std::condition_variable cv;  // notified on append AND on durability advance
  int fd = -1;
  std::deque<RecordMeta> recs;
  int64_t next_offset = 0;    // end (next to assign)
  int64_t base_offset = 0;    // begin (earliest retained)
  int64_t synced_offset = 0;  // offsets < this are fsynced (group commit)
  uint64_t file_end = 0;      // append position
  bool dirty = false;
  // A failed fsync POISONS the partition: Linux clears the kernel error
  // state and marks the lost pages clean, so a retried fsync would succeed
  // without the data — advancing the watermark over records that are not on
  // disk. Once set, appends fail and the watermark is frozen; producers see
  // error delivery reports instead of false DELIVERED acks.
  bool io_failed = false;

  ~Partition() {
    if (fd >= 0) ::close(fd);
  }
};

struct Topic {
  int num_partitions = 0;
  int64_t retention_ms = 0;
  std::vector<std::unique_ptr<Partition>> parts;
};

struct Broker {
  std::string dir;
  std::shared_mutex topics_mu;
  std::map<std::string, Topic> topics;

  std::mutex offsets_mu;
  std::map<std::string, int64_t> offsets;  // "group\x1ftopic\x1fpart" -> off
  int offsets_fd = -1;
  bool offsets_dirty = false;

  // group-commit flusher
  std::thread flusher;
  std::atomic<bool> stop{false};
  std::mutex stop_mu;
  std::condition_variable stop_cv;  // wakes the flusher early on shutdown
  int sync_interval_ms = 5;
  // serializes flush rounds: an explicit swb_flush that races the background
  // flusher must not return before in-flight fsyncs advance synced_offset
  std::mutex flush_mu;
  // external threads blocked in swb_wait_for_data / swb_wait_durable:
  // shutdown wakes every partition cv and spins until this drains before
  // deleting the Broker (otherwise a parked waiter's mutex/condvar would be
  // destroyed under it — use-after-free)
  std::atomic<int> waiters{0};

  ~Broker() {
    if (offsets_fd >= 0) ::close(offsets_fd);
  }
};

// "__offsets__.log" (and its ".tmp") is the offsets log in the log root: a
// topic folder of that name would collide with it.
bool reserved_name(const char* name) {
  return ::strncmp(name, "__offsets__", 11) == 0;
}

// Topic names become filesystem paths and offsets-log fields; reject anything
// that could escape the log dir or corrupt the tab/newline-framed offsets log.
bool valid_topic_name(const char* name) {
  if (!name || !*name) return false;
  size_t len = ::strlen(name);
  if (len > 255) return false;
  if (reserved_name(name)) return false;
  if (::strcmp(name, ".") == 0) return false;  // would write into the log root
  if (::strstr(name, "..")) return false;
  for (size_t i = 0; i < len; ++i) {
    unsigned char c = static_cast<unsigned char>(name[i]);
    if (c < 0x20 || c == 0x7f || c == '/' || c == '\\') return false;
  }
  return true;
}

// Percent-escape the separator/control bytes so arbitrary group ids (they are
// derived from agent ids arriving over HTTP) round-trip the offsets log.
std::string esc_field(const std::string& s) {
  std::string out;
  out.reserve(s.size());
  for (char ch : s) {
    switch (ch) {
      case '%': out += "%25"; break;
      case '\t': out += "%09"; break;
      case '\n': out += "%0A"; break;
      case '\r': out += "%0D"; break;
      case '\x1f': out += "%1F"; break;  // offsets_key field separator
      default: out += ch;
    }
  }
  return out;
}

int hex_val(char c) {
  if (c >= '0' && c <= '9') return c - '0';
  if (c >= 'A' && c <= 'F') return c - 'A' + 10;
  if (c >= 'a' && c <= 'f') return c - 'a' + 10;
  return -1;
}

std::string unesc_field(const std::string& s) {
  std::string out;
  out.reserve(s.size());
  for (size_t i = 0; i < s.size(); ++i) {
    if (s[i] == '%' && i + 2 < s.size()) {
      int hi = hex_val(s[i + 1]), lo = hex_val(s[i + 2]);
      if (hi >= 0 && lo >= 0) {
        out += static_cast<char>(hi * 16 + lo);
        i += 2;
        continue;
      }
    }
    out += s[i];
  }
  return out;
}

bool append_all(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t w = ::write(fd, p, n);
    if (w < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool write_all(int fd, const void* buf, size_t n, uint64_t pos) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t w = ::pwrite(fd, p, n, pos);
    if (w < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    p += w;
    pos += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool read_all(int fd, void* buf, size_t n, uint64_t pos) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::pread(fd, p, n, pos);
    if (r <= 0) {
      if (r < 0 && errno == EINTR) continue;
      return false;
    }
    p += r;
    pos += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

std::string part_path(const Broker& b, const std::string& topic, int part) {
  return b.dir + "/" + topic + "/" + std::to_string(part) + ".log";
}

// Sidecar persisting (base_offset, next_offset) across restarts. Without it
// a fully-trimmed partition would reopen with next_offset=0 and reuse
// offsets, stranding consumer groups committed past the trim point.
std::string off_path(const Broker& b, const std::string& topic, int part) {
  return b.dir + "/" + topic + "/" + std::to_string(part) + ".off";
}

bool save_part_offsets(const Broker& b, const std::string& topic, int part,
                       int64_t base, int64_t next) {
  std::string path = off_path(b, topic, part);
  std::string tmp = path + ".tmp";
  FILE* f = ::fopen(tmp.c_str(), "w");
  if (!f) return false;
  // every step checked: callers destroy the log ONLY on a durably-written
  // sidecar — an ENOSPC/partial write returning success here would recreate
  // the offset-reuse corruption the sidecar exists to prevent
  bool ok = ::fprintf(f, "%lld %lld\n", static_cast<long long>(base),
                      static_cast<long long>(next)) > 0;
  ok = ::fflush(f) == 0 && ok;
  ok = ::fsync(::fileno(f)) == 0 && ok;
  ok = ::fclose(f) == 0 && ok;
  if (!ok) {
    ::unlink(tmp.c_str());
    return false;
  }
  return ::rename(tmp.c_str(), path.c_str()) == 0;
}

bool load_part_offsets(const Broker& b, const std::string& topic, int part,
                       int64_t* base, int64_t* next) {
  FILE* f = ::fopen(off_path(b, topic, part).c_str(), "r");
  if (!f) return false;
  long long bb = 0, nn = 0;
  bool ok = ::fscanf(f, "%lld %lld", &bb, &nn) == 2;
  ::fclose(f);
  if (ok) {
    *base = bb;
    *next = nn;
  }
  return ok;
}

// Rebuild a partition's index by scanning its log; truncates a torn tail.
bool open_partition(Broker& b, const std::string& topic, int idx,
                    Partition& p) {
  std::string path = part_path(b, topic, idx);
  p.fd = ::open(path.c_str(), O_RDWR | O_CREAT, 0644);
  if (p.fd < 0) return false;
  struct stat st;
  if (::fstat(p.fd, &st) != 0) return false;
  uint64_t size = static_cast<uint64_t>(st.st_size), pos = 0;
  while (pos + sizeof(RecordHeader) <= size) {
    RecordHeader h;
    if (!read_all(p.fd, &h, sizeof(h), pos)) break;
    if (h.magic != kMagic || h.val_len < 0 || h.key_len < -1) break;
    uint64_t klen = h.key_len < 0 ? 0 : static_cast<uint64_t>(h.key_len);
    uint64_t total = sizeof(h) + klen + static_cast<uint64_t>(h.val_len);
    if (pos + total > size) break;  // torn tail
    p.recs.push_back({h.offset, h.timestamp, pos, h.key_len, h.val_len});
    pos += total;
  }
  if (pos < size) ::ftruncate(p.fd, static_cast<off_t>(pos));
  p.file_end = pos;
  if (!p.recs.empty()) {
    p.base_offset = p.recs.front().offset;
    p.next_offset = p.recs.back().offset + 1;
  }
  // everything that survived the scan is on disk already
  p.synced_offset = p.next_offset;
  // a trim sidecar may advance past what the file scan shows (fully- or
  // partially-trimmed logs keep their bytes; the head/tail are logical)
  int64_t base = 0, next = 0;
  if (load_part_offsets(b, topic, idx, &base, &next)) {
    if (next > p.next_offset) p.next_offset = next;
    if (base > p.base_offset) p.base_offset = base;
    while (!p.recs.empty() && p.recs.front().offset < p.base_offset)
      p.recs.pop_front();
    p.synced_offset = p.next_offset;
  }
  return true;
}

bool load_topic_meta(Broker& b, const std::string& name, Topic& t) {
  std::string meta = b.dir + "/" + name + "/meta";
  FILE* f = ::fopen(meta.c_str(), "r");
  if (!f) return false;
  int np = 0;
  long long ret = 0;
  bool ok = ::fscanf(f, "%d %lld", &np, &ret) == 2;
  ::fclose(f);
  if (!ok || np <= 0) return false;
  t.num_partitions = np;
  t.retention_ms = ret;
  return true;
}

bool save_topic_meta(Broker& b, const std::string& name, const Topic& t) {
  std::string meta = b.dir + "/" + name + "/meta";
  std::string tmp = meta + ".tmp";
  FILE* f = ::fopen(tmp.c_str(), "w");
  if (!f) return false;
  ::fprintf(f, "%d %lld\n", t.num_partitions,
            static_cast<long long>(t.retention_ms));
  ::fclose(f);
  return ::rename(tmp.c_str(), meta.c_str()) == 0;
}

std::string offsets_key(const char* group, const char* topic, int part) {
  std::string k(group);
  k += '\x1f';
  k += topic;
  k += '\x1f';
  k += std::to_string(part);
  return k;
}

// One offsets-log line: esc(group)<TAB>esc(topic)<TAB>part<TAB>offset<LF>.
std::string format_offset_line(const std::string& group,
                               const std::string& topic, int part,
                               long long off) {
  return esc_field(group) + '\t' + esc_field(topic) + '\t' +
         std::to_string(part) + '\t' + std::to_string(off) + '\n';
}

void load_offsets(Broker& b) {
  std::string path = b.dir + "/__offsets__.log";
  FILE* f = ::fopen(path.c_str(), "r");
  if (f) {
    // line-at-a-time with defensive parsing: a malformed line (torn tail,
    // short write merged with its successor) loses only itself — the parser
    // resyncs at the next newline instead of abandoning the rest of the log
    char* line = nullptr;
    size_t cap = 0;
    ssize_t n;
    while ((n = ::getline(&line, &cap, f)) >= 0) {
      std::string s(line, static_cast<size_t>(n));
      while (!s.empty() && (s.back() == '\n' || s.back() == '\r')) s.pop_back();
      size_t a = s.find('\t');
      size_t c = a == std::string::npos ? a : s.find('\t', a + 1);
      size_t d = c == std::string::npos ? c : s.find('\t', c + 1);
      if (d == std::string::npos || s.find('\t', d + 1) != std::string::npos)
        continue;
      errno = 0;
      char *pe = nullptr, *oe = nullptr;
      std::string ps = s.substr(c + 1, d - c - 1);
      std::string os = s.substr(d + 1);
      long part = ::strtol(ps.c_str(), &pe, 10);
      long long off = ::strtoll(os.c_str(), &oe, 10);
      if (errno || !pe || *pe || !oe || *oe || ps.empty() || os.empty())
        continue;
      std::string group = unesc_field(s.substr(0, a));
      std::string topic = unesc_field(s.substr(a + 1, c - a - 1));
      b.offsets[offsets_key(group.c_str(), topic.c_str(),
                            static_cast<int>(part))] = off;
    }
    ::free(line);
    ::fclose(f);
  }
  // compact: rewrite current state, then append from there
  std::string tmp = path + ".tmp";
  FILE* out = ::fopen(tmp.c_str(), "w");
  if (out) {
    for (auto& kv : b.offsets) {
      const std::string& k = kv.first;
      size_t a = k.find('\x1f'), c = k.rfind('\x1f');
      std::string ln = format_offset_line(
          k.substr(0, a), k.substr(a + 1, c - a - 1),
          ::atoi(k.substr(c + 1).c_str()), kv.second);
      ::fwrite(ln.data(), 1, ln.size(), out);
    }
    ::fclose(out);
    ::rename(tmp.c_str(), path.c_str());
  }
  b.offsets_fd = ::open(path.c_str(), O_WRONLY | O_APPEND | O_CREAT, 0644);
}

Topic* find_topic(Broker& b, const char* name) {
  auto it = b.topics.find(name);
  return it == b.topics.end() ? nullptr : &it->second;
}

// One group-commit round: fsync every dirty partition, advance its
// synced_offset to the pre-fsync end, and wake durability waiters. The fsync
// runs with the partition lock RELEASED (appends proceed concurrently; bytes
// written during the fsync are covered by the next round).
void flush_impl(Broker& b) {
  // Rounds are serialized: a caller that races an in-flight round blocks
  // here until that round's fsyncs have advanced synced_offset, so an
  // explicit flush returning implies every pre-call append is durable.
  std::unique_lock flush_lk(b.flush_mu);
  {
    std::shared_lock lk(b.topics_mu);
    for (auto& kv : b.topics) {
      for (auto& pp : kv.second.parts) {
        Partition& p = *pp;
        int fd;
        int64_t target;
        {
          std::unique_lock plk(p.mu);
          if (!p.dirty || p.fd < 0 || p.io_failed) continue;
          fd = p.fd;
          target = p.next_offset;
          p.dirty = false;
        }
        bool synced = ::fsync(fd) == 0;
        {
          std::unique_lock plk(p.mu);
          if (synced && !p.io_failed) {
            if (target > p.synced_offset) p.synced_offset = target;
          } else if (!synced) {
            // see Partition::io_failed: a retry would falsely succeed
            p.io_failed = true;
          }
          p.cv.notify_all();  // wake durability waiters either way
        }
      }
    }
  }
  std::unique_lock lk(b.offsets_mu);
  if (b.offsets_dirty && b.offsets_fd >= 0) {
    // keep dirty on failure; unlike the data log this is safe to retry —
    // commits are append-superseded, so a lost page only means replay
    // (at-least-once), never false durability
    if (::fsync(b.offsets_fd) == 0) b.offsets_dirty = false;
  }
}

void flusher_main(Broker* b) {
  for (;;) {
    {
      // stop-aware wait: shutdown must not block a full sync interval
      std::unique_lock lk(b->stop_mu);
      b->stop_cv.wait_for(lk, std::chrono::milliseconds(b->sync_interval_ms),
                          [&] { return b->stop.load(); });
    }
    if (b->stop.load()) break;
    flush_impl(*b);
  }
  flush_impl(*b);
}

}  // namespace

extern "C" {

void* swb_open2(const char* log_dir, int sync_interval_ms) {
  auto* b = new Broker();
  b->dir = log_dir;
  b->sync_interval_ms = sync_interval_ms > 0 ? sync_interval_ms : 5;
  ::mkdir(b->dir.c_str(), 0755);
  // discover existing topics (directories with a meta file)
  DIR* d = ::opendir(b->dir.c_str());
  if (d) {
    while (dirent* e = ::readdir(d)) {
      std::string name = e->d_name;
      if (name == "." || name == ".." || reserved_name(name.c_str())) continue;
      Topic t;
      if (!load_topic_meta(*b, name, t)) continue;
      bool ok = true;
      for (int i = 0; i < t.num_partitions; ++i) {
        auto p = std::make_unique<Partition>();
        if (!open_partition(*b, name, i, *p)) {
          ok = false;
          break;
        }
        t.parts.push_back(std::move(p));
      }
      if (!ok) {
        // never load a topic with parts.size() < num_partitions — the data
        // plane indexes parts[partition] after a num_partitions bound check
        ::fprintf(stderr, "swarmbroker: failed to open topic %s; skipping\n",
                  name.c_str());
        continue;
      }
      b->topics.emplace(name, std::move(t));
    }
    ::closedir(d);
  }
  load_offsets(*b);
  b->flusher = std::thread(flusher_main, b);
  return b;
}

void* swb_open(const char* log_dir) { return swb_open2(log_dir, 5); }

void swb_shutdown(void* bp) {
  auto* b = static_cast<Broker*>(bp);
  {
    std::unique_lock lk(b->stop_mu);
    b->stop.store(true);
  }
  b->stop_cv.notify_all();
  if (b->flusher.joinable()) b->flusher.join();
  // wake every parked waiter and wait for them to leave before freeing the
  // mutexes/condvars they are blocked on
  {
    std::shared_lock lk(b->topics_mu);
    for (auto& kv : b->topics)
      for (auto& pp : kv.second.parts) {
        std::unique_lock plk(pp->mu);
        pp->cv.notify_all();
      }
  }
  while (b->waiters.load(std::memory_order_acquire) > 0)
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
  delete b;
}

// 1 = created, 0 = existed, -1 = error (invalid name / partitions)
int swb_create_topic(void* bp, const char* name, int num_partitions,
                     long long retention_ms) {
  auto& b = *static_cast<Broker*>(bp);
  if (!valid_topic_name(name)) return -1;
  std::unique_lock lk(b.topics_mu);
  if (b.topics.count(name)) return 0;
  if (num_partitions <= 0) return -1;
  std::string tdir = b.dir + "/" + name;
  ::mkdir(tdir.c_str(), 0755);
  Topic t;
  t.num_partitions = num_partitions;
  t.retention_ms = retention_ms;
  for (int i = 0; i < num_partitions; ++i) {
    auto p = std::make_unique<Partition>();
    if (!open_partition(b, name, i, *p)) return -1;
    t.parts.push_back(std::move(p));
  }
  if (!save_topic_meta(b, name, t)) return -1;
  b.topics.emplace(name, std::move(t));
  return 1;
}

// JSON of {"topic": [num_partitions, retention_ms], ...}; caller frees via
// swb_free_buf.
char* swb_list_topics_json(void* bp) {
  auto& b = *static_cast<Broker*>(bp);
  std::shared_lock lk(b.topics_mu);
  std::string out = "{";
  bool first = true;
  for (auto& kv : b.topics) {
    if (!first) out += ",";
    first = false;
    out += "\"" + kv.first + "\":[" + std::to_string(kv.second.num_partitions) +
           "," + std::to_string(kv.second.retention_ms) + "]";
  }
  out += "}";
  char* buf = static_cast<char*>(::malloc(out.size() + 1));
  ::memcpy(buf, out.c_str(), out.size() + 1);
  return buf;
}

void swb_free_buf(char* p) { ::free(p); }

// grow only; 0 ok, -1 error
int swb_create_partitions(void* bp, const char* name, int new_total) {
  auto& b = *static_cast<Broker*>(bp);
  std::unique_lock lk(b.topics_mu);
  Topic* t = find_topic(b, name);
  if (!t) return -1;
  if (new_total <= t->num_partitions) return 0;
  for (int i = t->num_partitions; i < new_total; ++i) {
    auto p = std::make_unique<Partition>();
    if (!open_partition(b, name, i, *p)) return -1;
    t->parts.push_back(std::move(p));
  }
  t->num_partitions = new_total;
  return save_topic_meta(b, name, *t) ? 0 : -1;
}

// returns assigned offset, or -1
long long swb_append(void* bp, const char* topic, int partition,
                     const uint8_t* key, int key_len, const uint8_t* val,
                     int val_len, double timestamp) {
  auto& b = *static_cast<Broker*>(bp);
  std::shared_lock lk(b.topics_mu);
  Topic* t = find_topic(b, topic);
  if (!t || partition < 0 || partition >= t->num_partitions || val_len < 0)
    return -1;
  Partition& p = *t->parts[partition];
  std::unique_lock plk(p.mu);
  if (p.io_failed) return -1;
  RecordHeader h{kMagic, p.next_offset, timestamp, key ? key_len : -1, val_len};
  uint64_t klen = key ? static_cast<uint64_t>(key_len) : 0;
  std::vector<char> frame(sizeof(h) + klen + static_cast<uint64_t>(val_len));
  ::memcpy(frame.data(), &h, sizeof(h));
  if (key) ::memcpy(frame.data() + sizeof(h), key, klen);
  ::memcpy(frame.data() + sizeof(h) + klen, val, val_len);
  if (!write_all(p.fd, frame.data(), frame.size(), p.file_end)) return -1;
  p.recs.push_back({h.offset, timestamp, p.file_end, h.key_len, h.val_len});
  p.file_end += frame.size();
  p.dirty = true;
  long long off = p.next_offset++;
  p.cv.notify_all();
  return off;
}

// Packs up to max_records starting at >= offset into out:
//   per record: i64 offset, f64 ts, i32 key_len(-1 null), i32 val_len,
//               key bytes, val bytes
// Returns bytes written (>=0) and count via *out_count. If the FIRST
// record doesn't fit, returns -(needed bytes) so the caller can retry.
long long swb_fetch(void* bp, const char* topic, int partition,
                    long long offset, int max_records, uint8_t* out,
                    long long out_cap, int* out_count) {
  *out_count = 0;
  auto& b = *static_cast<Broker*>(bp);
  std::shared_lock lk(b.topics_mu);
  Topic* t = find_topic(b, topic);
  if (!t || partition < 0 || partition >= t->num_partitions) return -1;
  Partition& p = *t->parts[partition];
  std::unique_lock plk(p.mu);
  if (p.recs.empty()) return 0;
  int64_t front = p.recs.front().offset;
  int64_t idx = offset <= front ? 0 : offset - front;
  long long written = 0;
  int count = 0;
  while (idx < static_cast<int64_t>(p.recs.size()) && count < max_records) {
    const RecordMeta& m = p.recs[static_cast<size_t>(idx)];
    uint64_t klen = m.key_len < 0 ? 0 : static_cast<uint64_t>(m.key_len);
    long long need = 8 + 8 + 4 + 4 + static_cast<long long>(klen) + m.val_len;
    if (written + need > out_cap) {
      if (count == 0) return -need;
      break;
    }
    uint8_t* w = out + written;
    ::memcpy(w, &m.offset, 8);
    ::memcpy(w + 8, &m.timestamp, 8);
    ::memcpy(w + 16, &m.key_len, 4);
    ::memcpy(w + 20, &m.val_len, 4);
    if (!read_all(p.fd, w + 24, klen + static_cast<uint64_t>(m.val_len),
                  m.pos + sizeof(RecordHeader)))
      return -1;
    written += need;
    ++count;
    ++idx;
  }
  *out_count = count;
  return written;
}

long long swb_end_offset(void* bp, const char* topic, int partition) {
  auto& b = *static_cast<Broker*>(bp);
  std::shared_lock lk(b.topics_mu);
  Topic* t = find_topic(b, topic);
  if (!t || partition < 0 || partition >= t->num_partitions) return -1;
  Partition& p = *t->parts[partition];
  std::unique_lock plk(p.mu);
  return p.next_offset;
}

long long swb_begin_offset(void* bp, const char* topic, int partition) {
  auto& b = *static_cast<Broker*>(bp);
  std::shared_lock lk(b.topics_mu);
  Topic* t = find_topic(b, topic);
  if (!t || partition < 0 || partition >= t->num_partitions) return -1;
  Partition& p = *t->parts[partition];
  std::unique_lock plk(p.mu);
  return p.base_offset;
}

// RAII registration of a blocked external waiter; see Broker::waiters.
struct WaiterGuard {
  Broker& b;
  explicit WaiterGuard(Broker& broker) : b(broker) {
    b.waiters.fetch_add(1, std::memory_order_acq_rel);
  }
  ~WaiterGuard() { b.waiters.fetch_sub(1, std::memory_order_acq_rel); }
};

// 1 = data available at >= offset, 0 = timeout, -1 = error
int swb_wait_for_data(void* bp, const char* topic, int partition,
                      long long offset, double timeout_s) {
  auto& b = *static_cast<Broker*>(bp);
  WaiterGuard guard(b);
  if (b.stop.load()) return 0;
  Partition* p = nullptr;
  {
    // Resolve the partition under the topics lock, then RELEASE it before
    // blocking: a waiter holding it shared would queue create_partitions'
    // exclusive acquisition, and writer-preferring rwlocks would then stall
    // every append behind that — including the one being waited for.
    // Safe because topics are never deleted and Partition objects are
    // heap-owned (vector regrowth moves the unique_ptrs, not the objects).
    std::shared_lock lk(b.topics_mu);
    Topic* t = find_topic(b, topic);
    if (!t || partition < 0 || partition >= t->num_partitions) return -1;
    p = t->parts[partition].get();
  }
  std::unique_lock plk(p->mu);
  bool ok = p->cv.wait_for(
      plk, std::chrono::duration<double>(timeout_s),
      [&] { return p->next_offset > offset || b.stop.load(); });
  return (ok && p->next_offset > offset) ? 1 : 0;
}

void swb_commit_offset(void* bp, const char* group, const char* topic,
                       int partition, long long offset) {
  auto& b = *static_cast<Broker*>(bp);
  std::unique_lock lk(b.offsets_mu);
  b.offsets[offsets_key(group, topic, partition)] = offset;
  if (b.offsets_fd >= 0) {
    std::string line = format_offset_line(group, topic, partition, offset);
    // full-line write loop: a short write (ENOSPC) may still leave a partial
    // line, but load_offsets resyncs at the next newline so only this commit
    // is lost, and a later commit for the same key supersedes it anyway
    if (append_all(b.offsets_fd, line.data(), line.size()))
      b.offsets_dirty = true;
  }
}

// Durability plane: offsets < synced_offset are fsynced to the log. The
// Python Producer defers delivery callbacks until the record clears this
// watermark (`acks=all` semantics).
// -1 unknown topic/partition; -2 partition poisoned by a failed fsync
long long swb_durable_offset(void* bp, const char* topic, int partition) {
  auto& b = *static_cast<Broker*>(bp);
  std::shared_lock lk(b.topics_mu);
  Topic* t = find_topic(b, topic);
  if (!t || partition < 0 || partition >= t->num_partitions) return -1;
  Partition& p = *t->parts[partition];
  std::unique_lock plk(p.mu);
  if (p.io_failed) return -2;
  return p.synced_offset;
}

// 1 = record at `offset` is durable, 0 = timeout, -1 = error, -2 = poisoned
int swb_wait_durable(void* bp, const char* topic, int partition,
                     long long offset, double timeout_s) {
  auto& b = *static_cast<Broker*>(bp);
  WaiterGuard guard(b);
  if (b.stop.load()) return 0;
  Partition* p = nullptr;
  {
    std::shared_lock lk(b.topics_mu);
    Topic* t = find_topic(b, topic);
    if (!t || partition < 0 || partition >= t->num_partitions) return -1;
    p = t->parts[partition].get();
  }
  std::unique_lock plk(p->mu);
  bool ok = p->cv.wait_for(
      plk, std::chrono::duration<double>(timeout_s),
      [&] { return p->synced_offset > offset || p->io_failed || b.stop.load(); });
  if (p->io_failed && p->synced_offset <= offset) return -2;
  return (ok && p->synced_offset > offset) ? 1 : 0;
}

long long swb_committed_offset(void* bp, const char* group, const char* topic,
                               int partition) {
  auto& b = *static_cast<Broker*>(bp);
  std::unique_lock lk(b.offsets_mu);
  auto it = b.offsets.find(offsets_key(group, topic, partition));
  return it == b.offsets.end() ? -1 : it->second;
}

// Drop records with timestamp < cutoff_ts; returns count dropped.
// Space is reclaimed when a partition empties (file truncate); otherwise the
// head advance is logical (segment compaction is a future optimization).
long long swb_trim_older_than(void* bp, const char* topic, double cutoff_ts) {
  auto& b = *static_cast<Broker*>(bp);
  std::shared_lock lk(b.topics_mu);
  Topic* t = find_topic(b, topic);
  if (!t) return -1;
  long long dropped = 0;
  for (int i = 0; i < t->num_partitions; ++i) {
    Partition& p = *t->parts[i];
    std::unique_lock plk(p.mu);
    long long before = dropped;
    while (!p.recs.empty() && p.recs.front().timestamp < cutoff_ts) {
      p.recs.pop_front();
      ++dropped;
    }
    if (p.recs.empty() && dropped != before) {
      p.base_offset = p.next_offset;
      // durability order: sidecar first, THEN destroy the log bytes
      if (save_part_offsets(b, topic, i, p.base_offset, p.next_offset)) {
        ::ftruncate(p.fd, 0);
        p.file_end = 0;
        p.dirty = true;
        // trimmed records are gone by policy; release any durability waiters
        p.synced_offset = p.next_offset;
        p.cv.notify_all();
      }
    } else if (dropped != before) {
      p.base_offset = p.recs.front().offset;
      save_part_offsets(b, topic, i, p.base_offset, p.next_offset);
    }
  }
  return dropped;
}

void swb_flush(void* bp) { flush_impl(*static_cast<Broker*>(bp)); }

}  // extern "C"

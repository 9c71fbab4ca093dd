// Native rendezvous KV store — the TCPStore of this framework.
//
// Role parity: the reference's process-group bootstrap rides torch's C++
// TCPStore (env:// rendezvous behind MASTER_ADDR/MASTER_PORT,
// reference test_init.py:76-91; SURVEY §2.3). JAX's coordinator service
// covers the production path; this in-tree store covers the same role for
// framework-level coordination: rank discovery, key exchange, barriers —
// usable from multi-process CPU tests exactly like the reference's
// gloo-on-localhost strategy.
//
// Design: one server (thread-per-connection, in-memory map, blocking waits
// via condition_variable), tiny length-prefixed protocol:
//   request : op u8 | keylen u32 | key | vallen u32 | val
//   response: status u8 | vallen u32 | val
//   ops     : 'S' set, 'G' get (blocks until key exists), 'T' try-get
//             (non-blocking; status 2 when the key is missing), 'A' atomic
//             add (value is decimal i64; returns new value), 'D' delete,
//             'L' list keys with prefix (key = prefix; returns keys joined
//             by '\n'), 'P' delete every key with prefix (returns count),
//             'X' set with TTL (value = "<ttl-seconds>\n<payload>"; the key
//             expires lazily — purged on the next request after its
//             deadline, and treated as missing by G/T/L once expired).
//             TTL/prefix ops exist for coordination hygiene: claim keys
//             (fault claims, checkpoint shard-done claims) must not
//             accumulate across supervisor generations on a long-lived
//             server, nor alias a later generation's claims.
//             'H' hello (key = shared-secret token): when the server was
//             started with a token, this must be the FIRST frame on every
//             connection — wrong/missing token gets status 1 and the
//             socket closed. On a token-less server 'H' is a no-op, so
//             clients send it unconditionally whenever they hold a token.
// C ABI at the bottom; Python wrapper in tpu_sandbox_torch/runtime/kvstore.py.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

struct Server {
  int listen_fd = -1;
  int port = 0;
  std::string token;  // empty = no authentication (loopback deployments)
  std::map<std::string, std::string> data;
  std::map<std::string, Clock::time_point> expiry;  // keys set with TTL
  std::mutex mu;
  std::condition_variable cv;
  std::vector<std::thread> conns;
  std::vector<int> conn_fds;
  std::thread acceptor;
  std::mutex conns_mu;
  bool stopping = false;
};

// A signal whose handler was installed without SA_RESTART (Python's are)
// interrupts a blocked read or write with EINTR, nothing transferred: go on.
bool read_exact(int fd, void* buf, size_t n) {
  auto* p = static_cast<char*>(buf);
  while (n) {
    ssize_t r = ::read(fd, p, n);
    if (r < 0 && errno == EINTR) continue;
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

bool write_exact(int fd, const void* buf, size_t n) {
  auto* p = static_cast<const char*>(buf);
  while (n) {
    ssize_t r = ::write(fd, p, n);
    if (r < 0 && errno == EINTR) continue;
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

bool read_blob(int fd, std::string& out) {
  uint32_t len;
  if (!read_exact(fd, &len, 4)) return false;
  len = ntohl(len);
  if (len > (64u << 20)) return false;  // 64MB sanity cap
  out.resize(len);
  return len == 0 || read_exact(fd, out.data(), len);
}

bool write_response(int fd, uint8_t status, const std::string& val) {
  uint32_t len = htonl((uint32_t)val.size());
  return write_exact(fd, &status, 1) && write_exact(fd, &len, 4) &&
         (val.empty() || write_exact(fd, val.data(), val.size()));
}

// Lazily drop expired keys. Caller holds srv->mu.
void purge_expired(Server* srv) {
  auto now = Clock::now();
  for (auto it = srv->expiry.begin(); it != srv->expiry.end();) {
    if (it->second <= now) {
      srv->data.erase(it->first);
      it = srv->expiry.erase(it);
    } else {
      ++it;
    }
  }
}

// Key present and not past its TTL deadline. Caller holds srv->mu.
bool key_alive(Server* srv, const std::string& key) {
  if (!srv->data.count(key)) return false;
  auto it = srv->expiry.find(key);
  return it == srv->expiry.end() || it->second > Clock::now();
}

// Shared-secret handshake: when the server carries a token, the FIRST
// frame of every connection must be op 'H' with key == token. Constant
// framing (same request shape as every other op) keeps the client code
// one line; a wrong/missing token gets one error response and the socket
// closed before any store op is served.
bool authenticate(Server* srv, int fd) {
  if (srv->token.empty()) return true;
  uint8_t op;
  std::string key, val;
  if (!read_exact(fd, &op, 1) || !read_blob(fd, key) || !read_blob(fd, val))
    return false;
  if (op != 'H' || key != srv->token) {
    write_response(fd, 1, "auth required");
    return false;
  }
  return write_response(fd, 0, "");
}

void serve_loop(Server* srv, int fd);

void serve_conn(Server* srv, int fd) {
  if (authenticate(srv, fd)) serve_loop(srv, fd);
  {
    // deregister before closing: fd numbers get reused, and a stale entry
    // in conn_fds would make stop() shutdown() an unrelated future socket
    std::lock_guard<std::mutex> lk(srv->conns_mu);
    auto& v = srv->conn_fds;
    v.erase(std::remove(v.begin(), v.end(), fd), v.end());
  }
  ::close(fd);
}

void serve_loop(Server* srv, int fd) {
  for (;;) {
    uint8_t op;
    if (!read_exact(fd, &op, 1)) break;
    std::string key, val;
    if (!read_blob(fd, key) || !read_blob(fd, val)) break;
    if (op == 'H') {
      // hello to an unauthenticated server (client env carries a token the
      // server doesn't): harmless no-op, keeps client setup unconditional
      if (!write_response(fd, 0, "")) break;
    } else if (op == 'S') {
      {
        std::lock_guard<std::mutex> lk(srv->mu);
        purge_expired(srv);
        srv->data[key] = val;
        srv->expiry.erase(key);  // a plain set clears any previous TTL
      }
      srv->cv.notify_all();
      if (!write_response(fd, 0, "")) break;
    } else if (op == 'X') {
      // value = "<ttl-seconds>\n<payload>"
      size_t nl = val.find('\n');
      if (nl == std::string::npos) {
        write_response(fd, 1, "bad ttl");
        break;
      }
      double ttl = std::strtod(val.substr(0, nl).c_str(), nullptr);
      {
        std::lock_guard<std::mutex> lk(srv->mu);
        purge_expired(srv);
        srv->data[key] = val.substr(nl + 1);
        srv->expiry[key] =
            Clock::now() + std::chrono::duration_cast<Clock::duration>(
                               std::chrono::duration<double>(ttl));
      }
      srv->cv.notify_all();
      if (!write_response(fd, 0, "")) break;
    } else if (op == 'G') {
      std::string out;
      {
        std::unique_lock<std::mutex> lk(srv->mu);
        srv->cv.wait(lk, [&] {
          return srv->stopping || key_alive(srv, key);
        });
        if (srv->stopping) break;
        out = srv->data[key];
      }
      if (!write_response(fd, 0, out)) break;
    } else if (op == 'T') {
      std::string out;
      bool found;
      {
        std::lock_guard<std::mutex> lk(srv->mu);
        purge_expired(srv);
        found = key_alive(srv, key);
        if (found) out = srv->data[key];
      }
      if (!write_response(fd, found ? 0 : 2, out)) break;
    } else if (op == 'L') {
      // key = prefix; newline-joined matches (keys never contain '\n' in
      // this framework's usage — they are path-like ASCII identifiers)
      std::string out;
      {
        std::lock_guard<std::mutex> lk(srv->mu);
        purge_expired(srv);
        for (auto it = srv->data.lower_bound(key);
             it != srv->data.end() && it->first.compare(0, key.size(), key) == 0;
             ++it) {
          if (!out.empty()) out += '\n';
          out += it->first;
        }
      }
      if (!write_response(fd, 0, out)) break;
    } else if (op == 'P') {
      int64_t count = 0;
      {
        std::lock_guard<std::mutex> lk(srv->mu);
        auto it = srv->data.lower_bound(key);
        while (it != srv->data.end() &&
               it->first.compare(0, key.size(), key) == 0) {
          srv->expiry.erase(it->first);
          it = srv->data.erase(it);
          ++count;
        }
      }
      if (!write_response(fd, 0, std::to_string(count))) break;
    } else if (op == 'A') {
      int64_t delta = std::strtoll(val.c_str(), nullptr, 10);
      int64_t now;
      {
        std::lock_guard<std::mutex> lk(srv->mu);
        purge_expired(srv);
        int64_t cur = 0;
        auto it = srv->data.find(key);
        if (it != srv->data.end())
          cur = std::strtoll(it->second.c_str(), nullptr, 10);
        now = cur + delta;
        srv->data[key] = std::to_string(now);
        srv->expiry.erase(key);  // counters do not expire
      }
      srv->cv.notify_all();
      if (!write_response(fd, 0, std::to_string(now))) break;
    } else if (op == 'D') {
      {
        std::lock_guard<std::mutex> lk(srv->mu);
        srv->data.erase(key);
        srv->expiry.erase(key);
      }
      if (!write_response(fd, 0, "")) break;
    } else {
      write_response(fd, 1, "bad op");
      break;
    }
  }
}

}  // namespace

extern "C" {

// bind_addr: dotted-quad listen address — nullptr/"" means loopback (the
// safe single-host default); "0.0.0.0" opens the store to the network for
// real cross-host deployment, which is what token (nullptr/"" = no auth)
// exists for: every connection must then open with the shared secret.
Server* kv_server_start(const char* bind_addr, int port, const char* token) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  if (bind_addr == nullptr || bind_addr[0] == '\0') {
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  } else if (::inet_pton(AF_INET, bind_addr, &addr.sin_addr) != 1) {
    ::close(fd);
    return nullptr;
  }
  addr.sin_port = htons((uint16_t)port);
  if (::bind(fd, (sockaddr*)&addr, sizeof(addr)) != 0 || ::listen(fd, 64) != 0) {
    ::close(fd);
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  ::getsockname(fd, (sockaddr*)&addr, &alen);

  auto* srv = new Server();
  srv->listen_fd = fd;
  srv->port = ntohs(addr.sin_port);
  if (token != nullptr) srv->token = token;
  srv->acceptor = std::thread([srv] {
    for (;;) {
      int cfd = ::accept(srv->listen_fd, nullptr, nullptr);
      if (cfd < 0) return;  // listen socket closed -> shutdown
      // Request/response over multi-write() framing: without TCP_NODELAY,
      // Nagle + delayed ACK turns every round trip into ~40-90ms, which an
      // election or heartbeat loop pays per KV op.
      int one = 1;
      ::setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      std::lock_guard<std::mutex> lk(srv->conns_mu);
      if (srv->stopping) {
        ::close(cfd);
        return;
      }
      srv->conn_fds.push_back(cfd);
      srv->conns.emplace_back([srv, cfd] { serve_conn(srv, cfd); });
    }
  });
  return srv;
}

int kv_server_port(Server* srv) { return srv ? srv->port : -1; }

void kv_server_stop(Server* srv) {
  if (!srv) return;
  {
    std::lock_guard<std::mutex> lk(srv->mu);
    std::lock_guard<std::mutex> lk2(srv->conns_mu);
    srv->stopping = true;
  }
  srv->cv.notify_all();
  ::shutdown(srv->listen_fd, SHUT_RDWR);
  ::close(srv->listen_fd);
  srv->acceptor.join();
  {
    // unblock conn threads parked in read() on still-open client sockets —
    // without this, stop() deadlocks whenever a client outlives the server
    std::lock_guard<std::mutex> lk(srv->conns_mu);
    for (int fd : srv->conn_fds) ::shutdown(fd, SHUT_RDWR);
  }
  for (auto& t : srv->conns) t.join();
  delete srv;
}

int kv_connect(const char* host, int port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1 ||
      ::connect(fd, (sockaddr*)&addr, sizeof(addr)) != 0) {
    ::close(fd);
    return -1;
  }
  return fd;
}

static bool send_req(int fd, char op, const char* key, int64_t klen,
                     const char* val, int64_t vlen) {
  uint8_t opb = (uint8_t)op;
  uint32_t kl = htonl((uint32_t)klen), vl = htonl((uint32_t)vlen);
  return write_exact(fd, &opb, 1) && write_exact(fd, &kl, 4) &&
         (klen == 0 || write_exact(fd, key, (size_t)klen)) &&
         write_exact(fd, &vl, 4) && (vlen == 0 || write_exact(fd, val, (size_t)vlen));
}

// The response to the request last sent on fd: its value length (copied
// into out, up to out_cap), -2 when the server reports key-missing
// (try-get), -1 on error, or -3 when a signal interrupted the wait for its
// first byte (a blocking get can wait for long): the caller runs its
// signal handlers and calls kv_response again, or drops the connection.
int64_t kv_response(int fd, char* out, int64_t out_cap) {
  uint8_t status;
  ssize_t r = ::read(fd, &status, 1);
  if (r < 0 && errno == EINTR) return -3;
  if (r <= 0) return -1;
  std::string resp;
  if (!read_blob(fd, resp)) return -1;
  if (status == 2) return -2;
  if (status != 0) return -1;
  int64_t n = (int64_t)resp.size();
  if (out && out_cap > 0) std::memcpy(out, resp.data(), (size_t)std::min(n, out_cap));
  return n;
}

// Sends one request and returns kv_response's result for it.
int64_t kv_request(int fd, char op, const char* key, int64_t klen,
                   const char* val, int64_t vlen, char* out, int64_t out_cap) {
  if (!send_req(fd, op, key, klen, val, vlen)) return -1;
  return kv_response(fd, out, out_cap);
}

void kv_close(int fd) { ::close(fd); }

}  // extern "C"

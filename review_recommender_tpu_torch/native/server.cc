// Native HTTP serving front end for the search engine.
//
// The reference serves one request at a time through Streamlit
// (/root/reference/app/app_product_search.py:372-432). The TPU build's
// Python server (serve/api.py) already coalesces concurrent requests into
// one batched device program, but on a single-core host the stdlib
// HTTP/threading layer costs more than the TPU program itself (measured
// ~90% of serving wall time at 64 clients). This file moves the entire
// per-request I/O path to C++:
//
//   - single-threaded epoll event loop (accept, read, parse, write)
//   - HTTP/1.1 keep-alive parsing (Content-Length framing only)
//   - micro-batch assembly: POST /search bodies are held for a short
//     window (timerfd) or until max_batch, then handed to Python in ONE
//     ctypes callback — one GIL entry per window instead of per request
//   - every other route goes through a per-request Python fallback
//     callback, so the full API surface (readyz, debug, eval, UI, batch)
//     keeps exact Python semantics
//   - GET /healthz is answered natively (no GIL): liveness stays
//     responsive even while Python is busy compiling or dispatching
//
// Threading model: everything runs on one std::thread. While the Python
// callback executes, the loop is intentionally blocked — on a single-core
// host the work could not overlap anyway, and the kernel accept/receive
// queues absorb the burst (listen backlog 256). On multi-core hosts the
// design extends to an I/O thread + dispatcher thread; not needed here.
//
// Reply protocol: the Python callback calls rrt_server_reply(i, status,
// body, len) for each request WHILE the callback is on the stack; the
// server copies the bytes immediately, so Python-side buffers can die the
// moment the callback returns.
#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <stdint.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <sys/timerfd.h>
#include <unistd.h>

#include <atomic>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

typedef void (*rrt_batch_cb)(const char* const* bodies, const int64_t* lens,
                             int64_t n);
typedef void (*rrt_fallback_cb)(const char* method, const char* path,
                                const char* body, int64_t body_len);

constexpr size_t kMaxHeaderBytes = 64 * 1024;
constexpr int64_t kMaxBodyBytes = 16 * 1024 * 1024;

struct Conn {
  int fd = -1;
  std::string in;    // unparsed input bytes
  std::string out;   // unflushed response bytes
  // current request framing state
  bool have_headers = false;
  size_t header_len = 0;
  int64_t content_len = 0;
  std::string method;
  std::string path;
  bool keep_alive = true;
  // a /search request from this conn sits in the pending batch; parsing
  // of any pipelined follow-up is deferred until its response is written
  // (per-connection responses stay in request order)
  bool waiting = false;
  bool closing = false;  // close once `out` drains
};

struct Pending {
  Conn* conn;  // nulled if the connection dies before dispatch
  std::string body;
};

struct Reply {
  int status;
  std::string ctype;
  std::string body;
};

struct Server {
  int listen_fd = -1;
  int epoll_fd = -1;
  int timer_fd = -1;
  int wake_fd = -1;  // eventfd: stop signal
  int port = 0;
  double window_ms = 2.0;
  int64_t max_batch = 64;
  rrt_batch_cb batch_cb = nullptr;
  rrt_fallback_cb fallback_cb = nullptr;
  std::thread thread;
  std::atomic<bool> running{false};
  std::atomic<bool> stop_flag{false};

  std::unordered_map<int, Conn*> conns;
  std::vector<Pending> pending;
  bool timer_armed = false;
  // full-window dispatch request. parse_loop must NEVER run dispatch_batch
  // synchronously: dispatching frames replies and can close connections
  // (flush failure / Connection: close), and a parse_loop frame for one of
  // those connections may still be live on the stack below us — it would
  // resume on a freed Conn. Instead the flag is drained at the event-loop
  // top level, where no parse frame is live.
  bool dispatch_now = false;

  // reply slots for the in-flight callback (loop thread only)
  std::vector<Reply> replies;

  // stats (read from any thread)
  std::atomic<int64_t> n_requests{0};
  std::atomic<int64_t> n_batches{0};
  std::atomic<int64_t> n_coalesced{0};
  std::atomic<int64_t> n_fallback{0};
};

Server* g_server = nullptr;

const char* status_text(int code) {
  switch (code) {
    case 200: return "OK";
    case 400: return "Bad Request";
    case 404: return "Not Found";
    case 408: return "Request Timeout";
    case 413: return "Payload Too Large";
    case 431: return "Request Header Fields Too Large";
    case 503: return "Service Unavailable";
    default: return "Internal Server Error";
  }
}

void frame_response(Conn* c, int status, const char* body, size_t len,
                    const char* ctype = "application/json") {
  char head[256];
  int n = snprintf(head, sizeof(head),
                   "HTTP/1.1 %d %s\r\n"
                   "Content-Type: %s\r\n"
                   "Content-Length: %zu\r\n"
                   "%s"
                   "\r\n",
                   status, status_text(status), ctype, len,
                   c->keep_alive ? "" : "Connection: close\r\n");
  c->out.append(head, n);
  c->out.append(body, len);
  if (!c->keep_alive) c->closing = true;
}

void update_epoll(Server* s, Conn* c) {
  epoll_event ev{};
  ev.events = EPOLLIN | (c->out.empty() ? 0u : static_cast<uint32_t>(EPOLLOUT));
  ev.data.fd = c->fd;
  epoll_ctl(s->epoll_fd, EPOLL_CTL_MOD, c->fd, &ev);
}

void close_conn(Server* s, Conn* c) {
  for (auto& p : s->pending)
    if (p.conn == c) p.conn = nullptr;
  epoll_ctl(s->epoll_fd, EPOLL_CTL_DEL, c->fd, nullptr);
  close(c->fd);
  s->conns.erase(c->fd);
  delete c;
}

// try to flush c->out; returns false if the connection died
bool flush_out(Server* s, Conn* c) {
  while (!c->out.empty()) {
    ssize_t n = send(c->fd, c->out.data(), c->out.size(), MSG_NOSIGNAL);
    if (n > 0) {
      c->out.erase(0, static_cast<size_t>(n));
    } else if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      break;
    } else {
      close_conn(s, c);
      return false;
    }
  }
  if (c->out.empty() && c->closing) {
    close_conn(s, c);
    return false;
  }
  update_epoll(s, c);
  return true;
}

void arm_timer(Server* s) {
  if (s->timer_armed) return;
  itimerspec ts{};
  int64_t ns = static_cast<int64_t>(s->window_ms * 1e6);
  if (ns < 1) ns = 1;
  ts.it_value.tv_sec = ns / 1000000000;
  ts.it_value.tv_nsec = ns % 1000000000;
  timerfd_settime(s->timer_fd, 0, &ts, nullptr);
  s->timer_armed = true;
}

void disarm_timer(Server* s) {
  if (!s->timer_armed) return;
  itimerspec ts{};
  timerfd_settime(s->timer_fd, 0, &ts, nullptr);
  uint64_t buf;
  ssize_t r = read(s->timer_fd, &buf, sizeof(buf));  // drain if fired
  (void)r;
  s->timer_armed = false;
}

void parse_loop(Server* s, Conn* c);

void dispatch_batch(Server* s) {
  disarm_timer(s);
  if (s->pending.empty()) return;
  std::vector<Pending> batch;
  size_t take = std::min(s->pending.size(),
                         static_cast<size_t>(s->max_batch));
  batch.assign(s->pending.begin(), s->pending.begin() + take);
  s->pending.erase(s->pending.begin(), s->pending.begin() + take);

  std::vector<const char*> bodies(batch.size());
  std::vector<int64_t> lens(batch.size());
  for (size_t i = 0; i < batch.size(); ++i) {
    bodies[i] = batch[i].body.data();
    lens[i] = static_cast<int64_t>(batch[i].body.size());
  }
  s->replies.assign(batch.size(),
                    {500, "application/json", "{\"error\": \"no reply\"}"});
  s->batch_cb(bodies.data(), lens.data(),
              static_cast<int64_t>(batch.size()));
  s->n_batches.fetch_add(1);
  s->n_coalesced.fetch_add(static_cast<int64_t>(batch.size()));

  // move replies to a local before touching any connection: resuming a
  // conn's parse loop below can run a fallback or a nested dispatch,
  // both of which reassign s->replies
  std::vector<Reply> replies;
  replies.swap(s->replies);
  for (size_t i = 0; i < batch.size(); ++i) {
    Conn* c = batch[i].conn;
    if (c == nullptr) continue;  // client went away
    frame_response(c, replies[i].status, replies[i].body.data(),
                   replies[i].body.size(), replies[i].ctype.c_str());
    c->waiting = false;
    if (flush_out(s, c)) parse_loop(s, c);  // resume pipelined input
  }
  if (!s->pending.empty()) {
    // more arrived than max_batch while dispatching — request another
    // top-level pass (no recursion: the resumed parse_loops above may
    // still reference conns a recursive dispatch could close)
    if (static_cast<int64_t>(s->pending.size()) >= s->max_batch)
      s->dispatch_now = true;
    else
      arm_timer(s);
  }
}

void run_fallback(Server* s, Conn* c, const std::string& body) {
  s->replies.assign(
      1, {500, "application/json", "{\"error\": \"no reply\"}"});
  s->n_fallback.fetch_add(1);
  s->fallback_cb(c->method.c_str(), c->path.c_str(), body.data(),
                 static_cast<int64_t>(body.size()));
  Reply r;
  std::swap(r, s->replies[0]);
  frame_response(c, r.status, r.body.data(), r.body.size(),
                 r.ctype.c_str());
}

// case-insensitive header lookup inside [0, header_len); returns value
bool find_header(const std::string& in, size_t header_len, const char* name,
                 std::string* out) {
  size_t nlen = strlen(name);
  size_t pos = 0;
  while (pos < header_len) {
    size_t eol = in.find("\r\n", pos);
    if (eol == std::string::npos || eol > header_len) break;
    if (eol - pos > nlen && in[pos + nlen] == ':' &&
        strncasecmp(in.data() + pos, name, nlen) == 0) {
      size_t v = pos + nlen + 1;
      while (v < eol && (in[v] == ' ' || in[v] == '\t')) ++v;
      out->assign(in, v, eol - v);
      return true;
    }
    pos = eol + 2;
  }
  return false;
}

// parse as many complete requests out of c->in as possible
void parse_loop(Server* s, Conn* c) {
  while (!c->waiting && !c->closing) {
    if (!c->have_headers) {
      size_t hdr_end = c->in.find("\r\n\r\n");
      if (hdr_end == std::string::npos) {
        if (c->in.size() > kMaxHeaderBytes) {
          c->keep_alive = false;
          frame_response(c, 431, "{\"error\": \"headers too large\"}", 30);
          flush_out(s, c);
          return;
        }
        return;  // need more bytes
      }
      c->header_len = hdr_end + 2;  // include last line's CRLF
      // request line: METHOD SP PATH SP VERSION
      size_t sp1 = c->in.find(' ');
      size_t eol = c->in.find("\r\n");
      if (sp1 == std::string::npos || sp1 > eol) {
        c->keep_alive = false;
        frame_response(c, 400, "{\"error\": \"bad request line\"}", 29);
        flush_out(s, c);
        return;
      }
      size_t sp2 = c->in.find(' ', sp1 + 1);
      if (sp2 == std::string::npos || sp2 > eol) sp2 = eol;
      c->method.assign(c->in, 0, sp1);
      c->path.assign(c->in, sp1 + 1, sp2 - sp1 - 1);
      std::string version =
          sp2 < eol ? c->in.substr(sp2 + 1, eol - sp2 - 1) : "HTTP/1.0";
      std::string v;
      c->keep_alive = version == "HTTP/1.1";
      if (find_header(c->in, c->header_len, "Connection", &v)) {
        if (strcasecmp(v.c_str(), "close") == 0) c->keep_alive = false;
        if (strcasecmp(v.c_str(), "keep-alive") == 0) c->keep_alive = true;
      }
      c->content_len = 0;
      if (find_header(c->in, c->header_len, "Content-Length", &v))
        c->content_len = strtoll(v.c_str(), nullptr, 10);
      if (c->content_len < 0 || c->content_len > kMaxBodyBytes) {
        c->keep_alive = false;
        frame_response(c, 413, "{\"error\": \"payload too large\"}", 30);
        flush_out(s, c);
        return;
      }
      c->have_headers = true;
      c->in.erase(0, hdr_end + 4);
    }
    if (static_cast<int64_t>(c->in.size()) < c->content_len)
      return;  // need more body bytes

    std::string body(c->in, 0, static_cast<size_t>(c->content_len));
    c->in.erase(0, static_cast<size_t>(c->content_len));
    c->have_headers = false;
    s->n_requests.fetch_add(1);

    if (c->method == "GET" && c->path == "/healthz") {
      // native liveness: answered without touching the GIL
      frame_response(c, 200, "{\"status\": \"ok\"}", 16);
    } else if (c->method == "POST" && c->path == "/search") {
      c->waiting = true;
      s->pending.push_back({c, std::move(body)});
      if (static_cast<int64_t>(s->pending.size()) >= s->max_batch)
        s->dispatch_now = true;  // drained at event-loop top level — a
        // synchronous dispatch here could delete THIS conn and then
        // resume this very parse frame on freed memory
      else
        arm_timer(s);
      // response is framed at dispatch; stop parsing this conn until then
    } else {
      run_fallback(s, c, body);
    }
    if (!c->waiting && !flush_out(s, c)) return;  // conn died
  }
}

void on_readable(Server* s, Conn* c) {
  char buf[16384];
  for (;;) {
    ssize_t n = recv(c->fd, buf, sizeof(buf), 0);
    if (n > 0) {
      c->in.append(buf, static_cast<size_t>(n));
      if (n < static_cast<ssize_t>(sizeof(buf))) break;
    } else if (n == 0) {
      close_conn(s, c);
      return;
    } else if (errno == EAGAIN || errno == EWOULDBLOCK) {
      break;
    } else {
      close_conn(s, c);
      return;
    }
  }
  parse_loop(s, c);
}

void event_loop(Server* s) {
  constexpr int kMaxEvents = 64;
  epoll_event events[kMaxEvents];
  while (!s->stop_flag.load()) {
    int n = epoll_wait(s->epoll_fd, events, kMaxEvents, 1000);
    if (n < 0) {
      if (errno == EINTR) continue;
      break;
    }
    for (int i = 0; i < n; ++i) {
      int fd = events[i].data.fd;
      if (fd == s->wake_fd) {
        uint64_t v;
        ssize_t r = read(s->wake_fd, &v, sizeof(v));
        (void)r;
        continue;  // stop_flag checked at loop top
      }
      if (fd == s->timer_fd) {
        uint64_t v;
        ssize_t r = read(s->timer_fd, &v, sizeof(v));
        (void)r;
        s->timer_armed = false;
        s->dispatch_now = true;  // drained after this event batch, so a
        // dispatch can't close a conn whose events are later in `events`
        continue;
      }
      if (fd == s->listen_fd) {
        for (;;) {
          int cfd = accept4(s->listen_fd, nullptr, nullptr, SOCK_NONBLOCK);
          if (cfd < 0) break;
          int one = 1;
          setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          Conn* c = new Conn();
          c->fd = cfd;
          s->conns[cfd] = c;
          epoll_event ev{};
          ev.events = EPOLLIN;
          ev.data.fd = cfd;
          epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, cfd, &ev);
        }
        continue;
      }
      auto it = s->conns.find(fd);
      if (it == s->conns.end()) continue;
      Conn* c = it->second;
      if (events[i].events & (EPOLLHUP | EPOLLERR)) {
        close_conn(s, c);
        continue;
      }
      if (events[i].events & EPOLLOUT) {
        if (!flush_out(s, c)) continue;
      }
      if (events[i].events & EPOLLIN) on_readable(s, c);
    }
    // top-level dispatch point: every parse frame has unwound, so
    // dispatch_batch may freely close connections. Dispatching can resume
    // pipelined input that fills another window — keep draining.
    while (s->dispatch_now) {
      s->dispatch_now = false;
      dispatch_batch(s);
    }
  }
  // flush every pending batch so no in-flight client hangs on shutdown
  while (!s->pending.empty()) dispatch_batch(s);
  for (auto& kv : s->conns) {
    close(kv.first);
    delete kv.second;
  }
  s->conns.clear();
  s->running.store(false);
}

}  // namespace

extern "C" {

// Start the server; returns the bound port (>0) or -1. One instance per
// process. window_ms/max_batch: micro-batch window for POST /search.
int64_t rrt_server_start(const char* host, int32_t port, double window_ms,
                         int64_t max_batch, rrt_batch_cb batch_cb,
                         rrt_fallback_cb fallback_cb) {
  if (g_server != nullptr && g_server->running.load()) return -1;
  if (g_server != nullptr) {
    if (g_server->thread.joinable()) g_server->thread.join();
    delete g_server;
    g_server = nullptr;
  }
  Server* s = new Server();
  s->window_ms = window_ms;
  s->max_batch = max_batch > 0 ? max_batch : 64;
  s->batch_cb = batch_cb;
  s->fallback_cb = fallback_cb;

  s->listen_fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  if (s->listen_fd < 0) {
    delete s;
    return -1;
  }
  int one = 1;
  setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  addr.sin_addr.s_addr =
      host && *host ? inet_addr(host) : htonl(INADDR_LOOPBACK);
  if (bind(s->listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) <
          0 ||
      listen(s->listen_fd, 256) < 0) {
    close(s->listen_fd);
    delete s;
    return -1;
  }
  socklen_t alen = sizeof(addr);
  getsockname(s->listen_fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  s->port = ntohs(addr.sin_port);

  s->epoll_fd = epoll_create1(0);
  s->timer_fd = timerfd_create(CLOCK_MONOTONIC, TFD_NONBLOCK);
  s->wake_fd = eventfd(0, EFD_NONBLOCK);
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.fd = s->listen_fd;
  epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, s->listen_fd, &ev);
  ev.data.fd = s->timer_fd;
  epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, s->timer_fd, &ev);
  ev.data.fd = s->wake_fd;
  epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, s->wake_fd, &ev);

  s->running.store(true);
  g_server = s;
  s->thread = std::thread(event_loop, s);
  return s->port;
}

// Called by Python DURING a batch/fallback callback: record request i's
// response. Bytes are copied immediately.
void rrt_server_reply(int64_t i, int32_t status, const char* content_type,
                      const char* body, int64_t len) {
  Server* s = g_server;
  if (s == nullptr || i < 0 ||
      i >= static_cast<int64_t>(s->replies.size()))
    return;
  s->replies[static_cast<size_t>(i)] = {
      status, content_type ? content_type : "application/json",
      std::string(body, static_cast<size_t>(len))};
}

void rrt_server_stop(void) {
  Server* s = g_server;
  if (s == nullptr) return;
  s->stop_flag.store(true);
  uint64_t v = 1;
  ssize_t r = write(s->wake_fd, &v, sizeof(v));
  (void)r;
  if (s->thread.joinable()) s->thread.join();
  close(s->listen_fd);
  close(s->epoll_fd);
  close(s->timer_fd);
  close(s->wake_fd);
  delete s;
  g_server = nullptr;
}

int32_t rrt_server_port(void) {
  Server* s = g_server;
  return s == nullptr ? -1 : s->port;
}

int32_t rrt_server_running(void) {
  Server* s = g_server;
  return s != nullptr && s->running.load() ? 1 : 0;
}

// requests, batches, coalesced, fallbacks
void rrt_server_stats(int64_t* out4) {
  Server* s = g_server;
  if (s == nullptr) {
    out4[0] = out4[1] = out4[2] = out4[3] = 0;
    return;
  }
  out4[0] = s->n_requests.load();
  out4[1] = s->n_batches.load();
  out4[2] = s->n_coalesced.load();
  out4[3] = s->n_fallback.load();
}

}  // extern "C"

// msgbus — a minimal topic-based pub/sub message broker.
//
// The framework's replacement for the reference's ROS1/TCPROS
// transport (reference: catkin/rospy node graph, CMakeLists.txt:13-37,
// car_racing/racing/realtime/*.py): a single-threaded poll(2) TCP broker
// that fans published frames out to topic subscribers.  Python nodes speak
// the frame protocol below over a socket (car_racing_tpu/realtime/bus.py).
//
// Frame protocol (little-endian):
//   [u32 frame_len][u8 type][payload]
//   type 1 SUB   payload = topic utf-8
//   type 2 UNSUB payload = topic utf-8
//   type 3 PUB   payload = [u16 topic_len][topic][data]
//   type 4 MSG   (broker -> client) same layout as PUB
//
// Build:  g++ -O2 -std=c++17 -o msgbus msgbus.cpp
// Run:    ./msgbus <port>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <signal.h>
#include <unistd.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <set>
#include <string>
#include <vector>

namespace {

constexpr uint8_t kSub = 1;
constexpr uint8_t kUnsub = 2;
constexpr uint8_t kPub = 3;
constexpr uint8_t kMsg = 4;
constexpr size_t kMaxFrame = 64 * 1024 * 1024;

struct Conn {
  int fd = -1;
  std::vector<uint8_t> inbuf;
  std::vector<uint8_t> outbuf;
  std::set<std::string> topics;
  bool dead = false;
};

std::map<int, Conn> conns;

void queue_frame(Conn& c, uint8_t type, const uint8_t* payload, uint32_t n) {
  uint32_t len = 1 + n;
  uint8_t hdr[5];
  memcpy(hdr, &len, 4);
  hdr[4] = type;
  c.outbuf.insert(c.outbuf.end(), hdr, hdr + 5);
  c.outbuf.insert(c.outbuf.end(), payload, payload + n);
}

void handle_frame(Conn& c, uint8_t type, const uint8_t* p, uint32_t n) {
  switch (type) {
    case kSub:
      c.topics.emplace(reinterpret_cast<const char*>(p), n);
      break;
    case kUnsub:
      c.topics.erase(std::string(reinterpret_cast<const char*>(p), n));
      break;
    case kPub: {
      if (n < 2) return;
      uint16_t tlen;
      memcpy(&tlen, p, 2);
      if (2u + tlen > n) return;
      std::string topic(reinterpret_cast<const char*>(p + 2), tlen);
      for (auto& [fd, other] : conns) {
        if (other.dead) continue;
        if (other.topics.count(topic)) {
          queue_frame(other, kMsg, p, n);
        }
      }
      break;
    }
    default:
      break;
  }
}

void drain_input(Conn& c) {
  size_t off = 0;
  while (c.inbuf.size() - off >= 5) {
    uint32_t len;
    memcpy(&len, c.inbuf.data() + off, 4);
    if (len < 1 || len > kMaxFrame) {
      c.dead = true;
      return;
    }
    if (c.inbuf.size() - off < 4u + len) break;
    uint8_t type = c.inbuf[off + 4];
    handle_frame(c, type, c.inbuf.data() + off + 5, len - 1);
    off += 4u + len;
  }
  if (off) c.inbuf.erase(c.inbuf.begin(), c.inbuf.begin() + off);
}

}  // namespace

int main(int argc, char** argv) {
  int port = argc > 1 ? atoi(argv[1]) : 9123;
  signal(SIGPIPE, SIG_IGN);

  int lfd = socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(lfd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    perror("bind");
    return 1;
  }
  listen(lfd, 64);
  fprintf(stderr, "msgbus listening on 127.0.0.1:%d\n", port);
  fflush(stderr);

  std::vector<uint8_t> rbuf(1 << 16);
  for (;;) {
    std::vector<pollfd> pfds;
    pfds.push_back({lfd, POLLIN, 0});
    for (auto& [fd, c] : conns) {
      short ev = POLLIN;
      if (!c.outbuf.empty()) ev |= POLLOUT;
      pfds.push_back({fd, ev, 0});
    }
    if (poll(pfds.data(), pfds.size(), -1) < 0) continue;

    if (pfds[0].revents & POLLIN) {
      int fd = accept(lfd, nullptr, nullptr);
      if (fd >= 0) {
        setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        conns[fd].fd = fd;
      }
    }
    for (size_t i = 1; i < pfds.size(); ++i) {
      auto it = conns.find(pfds[i].fd);
      if (it == conns.end()) continue;
      Conn& c = it->second;
      if (pfds[i].revents & (POLLERR | POLLHUP)) c.dead = true;
      if (!c.dead && (pfds[i].revents & POLLIN)) {
        ssize_t r = read(c.fd, rbuf.data(), rbuf.size());
        if (r <= 0) {
          c.dead = true;
        } else {
          c.inbuf.insert(c.inbuf.end(), rbuf.data(), rbuf.data() + r);
          drain_input(c);
        }
      }
      if (!c.dead && (pfds[i].revents & POLLOUT) && !c.outbuf.empty()) {
        ssize_t w = write(c.fd, c.outbuf.data(), c.outbuf.size());
        if (w < 0) {
          c.dead = true;
        } else {
          c.outbuf.erase(c.outbuf.begin(), c.outbuf.begin() + w);
        }
      }
    }
    for (auto it = conns.begin(); it != conns.end();) {
      if (it->second.dead) {
        close(it->second.fd);
        it = conns.erase(it);
      } else {
        ++it;
      }
    }
  }
}

// hetpu native runtime: TCP transport + size-prefixed framing.
//
// Counterpart of the reference's native socket layer
// (src/core/socket_io.cpp read_all/write_all; client.cpp:20-64 connect
// scan; server.cpp:27-90 bind/listen/accept on ports 8080-8100) — the
// byte-transport under the client/server offload protocol.  Exposed to
// Python via ctypes (hetpu/runtime/native.py); the hot framing loop
// (short-read/short-write handling, 8-byte LE size headers) runs in C++.
//
// Build: g++ -O2 -shared -fPIC -o libhetpu_io.so hetpu_io.cpp

#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

extern "C" {

// Loop until exactly `size` bytes are moved; returns bytes moved or -1.
// (reference socket_io.cpp:8-22)
int64_t hetpu_read_all(int fd, void *buf, int64_t size) {
  char *p = static_cast<char *>(buf);
  int64_t done = 0;
  while (done < size) {
    ssize_t r = read(fd, p + done, static_cast<size_t>(size - done));
    if (r < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    if (r == 0) return done;  // EOF: partial count (reference parity)
    done += r;
  }
  return done;
}

// (reference socket_io.cpp:24-40)
int64_t hetpu_write_all(int fd, const void *buf, int64_t size) {
  const char *p = static_cast<const char *>(buf);
  int64_t done = 0;
  while (done < size) {
    ssize_t w = write(fd, p + done, static_cast<size_t>(size - done));
    if (w < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    done += w;
  }
  return done;
}

// Framed message: 8-byte little-endian size header, then payload
// (reference client.cpp:120-126 / server.cpp:100-107 framing).
int64_t hetpu_send_frame(int fd, const void *buf, int64_t size) {
  uint64_t hdr = static_cast<uint64_t>(size);
  if (hetpu_write_all(fd, &hdr, 8) != 8) return -1;
  return hetpu_write_all(fd, buf, size);
}

// Reads the header; returns payload size or -1.  Caller then calls
// hetpu_read_all for the payload.
int64_t hetpu_recv_frame_size(int fd) {
  uint64_t hdr = 0;
  int64_t r = hetpu_read_all(fd, &hdr, 8);
  if (r != 8) return -1;
  return static_cast<int64_t>(hdr);
}

// Server: bind+listen on the first free port in [port_lo, port_hi]
// (reference server.cpp:27-90 port scan).  Returns listening fd, writes
// the chosen port to *chosen_port; -1 on failure.
int hetpu_listen(int port_lo, int port_hi, int *chosen_port) {
  for (int port = port_lo; port <= port_hi; ++port) {
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return -1;
    int opt = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &opt, sizeof(opt));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (bind(fd, reinterpret_cast<sockaddr *>(&addr), sizeof(addr)) == 0 &&
        listen(fd, 1) == 0) {
      if (chosen_port) *chosen_port = port;
      return fd;
    }
    close(fd);
  }
  return -1;
}

int hetpu_accept(int listen_fd) {
  int fd = accept(listen_fd, nullptr, nullptr);
  if (fd >= 0) {
    int opt = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &opt, sizeof(opt));
  }
  return fd;
}

// Client: connect to 127.0.0.1, scanning [port_lo, port_hi]
// (reference client.cpp:20-64).  Returns connected fd or -1.
int hetpu_connect(int port_lo, int port_hi) {
  for (int port = port_lo; port <= port_hi; ++port) {
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return -1;
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (connect(fd, reinterpret_cast<sockaddr *>(&addr), sizeof(addr)) == 0) {
      int opt = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &opt, sizeof(opt));
      return fd;
    }
    close(fd);
  }
  return -1;
}

int hetpu_close(int fd) { return close(fd); }

}  // extern "C"

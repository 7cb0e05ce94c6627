// Native tar-shard reader for the streaming video-latent datasets (the port's
// copy of the JAX package's native/tar_reader.cpp; the code below this
// header is the same).
//
// The wansynth trainers stream {key}.{field}.npy members out of tar shards
// (interpolated_diffusion_tpu_torch/data/wan_synth.py). Python's tarfile
// walks headers and copies member bytes under the GIL, which serialises the
// prefetch threads (utils/prefetch.py). This library indexes a shard's
// ustar headers once and serves members with pread(): ctypes foreign calls
// drop the GIL, so N prefetch threads do N concurrent reads, and the page
// cache keeps later epochs hot. The Python bindings and the npy decode
// (cheap, header only) are in interpolated_diffusion_tpu_torch/data/native_tar.py,
// which builds this file with g++ into build/native/<hash>/libtar_native.so.
//
// Handles plain ustar plus the PAX (x/g) and GNU longname (L/K) entries
// Python's tarfile may emit: metadata entries are skipped; an 'L' longname
// or a PAX `path=` record overrides the following member's name, so long
// keys round-trip.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

struct Member {
  std::string name;
  int64_t offset;  // payload offset in the file
  int64_t size;
};

struct TarIndex {
  int fd = -1;
  std::vector<Member> members;
};

int64_t parse_octal(const char* p, size_t n) {
  // base-256 (GNU) large-number encoding: high bit of first byte set
  if (n > 0 && (static_cast<unsigned char>(p[0]) & 0x80)) {
    int64_t v = static_cast<unsigned char>(p[0]) & 0x7f;
    for (size_t i = 1; i < n; ++i)
      v = (v << 8) | static_cast<unsigned char>(p[i]);
    return v;
  }
  int64_t v = 0;
  size_t i = 0;
  while (i < n && (p[i] == ' ' || p[i] == '\0')) ++i;
  for (; i < n && p[i] >= '0' && p[i] <= '7'; ++i) v = v * 8 + (p[i] - '0');
  return v;
}

// PAX payload: repeated "<len> key=value\n" records; return value for key
bool pax_lookup(const std::string& payload, const char* key,
                std::string* out) {
  size_t pos = 0;
  const std::string want = std::string(key) + "=";
  while (pos < payload.size()) {
    size_t sp = payload.find(' ', pos);
    if (sp == std::string::npos) break;
    long rec_len = strtol(payload.c_str() + pos, nullptr, 10);
    if (rec_len <= 0 || pos + rec_len > payload.size()) break;
    std::string rec = payload.substr(sp + 1, pos + rec_len - sp - 2);
    if (rec.compare(0, want.size(), want) == 0) {
      *out = rec.substr(want.size());
      return true;
    }
    pos += rec_len;
  }
  return false;
}

}  // namespace

extern "C" {

TarIndex* tar_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  auto* idx = new TarIndex();
  idx->fd = fd;

  char hdr[512];
  int64_t off = 0;
  std::string pending_name;  // from 'L' longname or PAX path=
  bool have_pending = false;
  while (true) {
    ssize_t r = pread(fd, hdr, 512, off);
    if (r != 512) break;
    if (hdr[0] == '\0') break;  // end-of-archive zero block
    int64_t size = parse_octal(hdr + 124, 12);
    char type = hdr[156];
    int64_t payload = off + 512;
    int64_t blocks = (size + 511) / 512;

    if (type == 'L' || type == 'x') {
      // GNU longname / PAX extended header: read payload, remember name
      std::string buf(static_cast<size_t>(size), '\0');
      if (pread(fd, buf.data(), size, payload) == size) {
        if (type == 'L') {
          pending_name.assign(buf.c_str());  // NUL-terminated
          have_pending = true;
        } else {
          std::string p;
          if (pax_lookup(buf, "path", &p)) {
            pending_name = p;
            have_pending = true;
          }
        }
      }
    } else if (type == '0' || type == '\0') {  // regular file
      Member m;
      if (have_pending) {
        m.name = pending_name;
        have_pending = false;
      } else {
        char name[257];
        // ustar prefix field (345, 155 bytes) + name (0, 100 bytes)
        char prefix[156];
        memcpy(prefix, hdr + 345, 155);
        prefix[155] = '\0';
        char base[101];
        memcpy(base, hdr, 100);
        base[100] = '\0';
        if (prefix[0] != '\0' &&
            memcmp(hdr + 257, "ustar", 5) == 0) {
          snprintf(name, sizeof(name), "%s/%s", prefix, base);
        } else {
          snprintf(name, sizeof(name), "%s", base);
        }
        m.name = name;
      }
      m.offset = payload;
      m.size = size;
      idx->members.push_back(std::move(m));
    } else {
      have_pending = false;  // 'g'/'K'/dirs etc: skip payload, drop override
    }
    off = payload + blocks * 512;
  }
  return idx;
}

void tar_close(TarIndex* idx) {
  if (!idx) return;
  if (idx->fd >= 0) close(idx->fd);
  delete idx;
}

int tar_count(const TarIndex* idx) {
  return idx ? static_cast<int>(idx->members.size()) : 0;
}

const char* tar_name(const TarIndex* idx, int i) {
  if (!idx || i < 0 || i >= static_cast<int>(idx->members.size()))
    return nullptr;
  return idx->members[i].name.c_str();
}

long long tar_size(const TarIndex* idx, int i) {
  if (!idx || i < 0 || i >= static_cast<int>(idx->members.size())) return -1;
  return idx->members[i].size;
}

long long tar_read(const TarIndex* idx, int i, void* buf, long long cap) {
  if (!idx || i < 0 || i >= static_cast<int>(idx->members.size())) return -1;
  const Member& m = idx->members[i];
  if (cap < m.size) return -1;
  int64_t done = 0;
  while (done < m.size) {
    ssize_t r = pread(idx->fd, static_cast<char*>(buf) + done,
                      m.size - done, m.offset + done);
    if (r <= 0) return -1;
    done += r;
  }
  return m.size;
}

}  // extern "C"

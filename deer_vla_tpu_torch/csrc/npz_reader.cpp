// Native CALVIN episode reader: zip(npz) parsing + threaded window loads.
//
// The reference's data path is torch DataLoader worker processes calling
// np.load per episode_XXXXXXX.npz frame (robot_flamingo/data/data.py:660-685)
// — per-frame Python/zipfile overhead dominates at small files.  This
// library reads STORED (uncompressed) npz members — np.savez's default and
// the CALVIN dataset format — with direct pread() into the caller's batch
// buffer, fanning a window of frames across a thread pool.  DEFLATE members
// (savez_compressed) inflate through zlib, so the native path covers every
// npz the datasets produce.
//
// Exposed C ABI (ctypes):
//   npz_probe(path, key, shape_out[8], ndim_out, dtype_out[8], nbytes_out)
//   npz_read (path, key, out, out_cap)                      -> 0 on success
//   npz_read_many(paths, n, key, out, item_nbytes, n_threads)
//     reads n files' identical-shape arrays into out[i * item_nbytes].
// Error codes: 0 ok, -1 io, -2 not found, -3 compressed (fallback),
//              -4 parse error, -5 buffer too small.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <algorithm>
#include <vector>

#include <fcntl.h>     // open (mmap fast path)
#include <sys/mman.h>  // mmap/munmap/madvise
#include <sys/stat.h>  // fstat
#include <unistd.h>    // close

#include <zlib.h>  // DEFLATE members (savez_compressed)

namespace {

struct Member {
  uint64_t data_offset;  // absolute offset of the npy payload's start
  uint64_t comp_size;
  uint64_t uncomp_size;  // from the central directory (probe needs it
                         // without inflating the whole member)
  uint16_t method;
};

uint16_t rd16(const unsigned char* p) { return p[0] | (p[1] << 8); }
uint32_t rd32(const unsigned char* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
}

// Locate `key`.npy (or `key`) in the zip central directory.
int find_member(FILE* f, const std::string& key, Member* out) {
  if (fseek(f, 0, SEEK_END) != 0) return -1;
  long fsize = ftell(f);
  long scan = fsize < 66000 ? fsize : 66000;
  std::vector<unsigned char> tail(scan);
  if (fseek(f, fsize - scan, SEEK_SET) != 0) return -1;
  if (fread(tail.data(), 1, scan, f) != (size_t)scan) return -1;
  long eocd = -1;
  for (long i = scan - 22; i >= 0; --i) {
    if (rd32(&tail[i]) == 0x06054b50) { eocd = i; break; }
  }
  if (eocd < 0) return -4;
  uint16_t n_entries = rd16(&tail[eocd + 10]);
  uint32_t cd_size = rd32(&tail[eocd + 12]);
  uint32_t cd_off = rd32(&tail[eocd + 16]);

  std::vector<unsigned char> cd(cd_size);
  if (fseek(f, cd_off, SEEK_SET) != 0) return -1;
  if (fread(cd.data(), 1, cd_size, f) != cd_size) return -1;

  std::string want1 = key + ".npy";
  size_t p = 0;
  for (int e = 0; e < n_entries && p + 46 <= cd_size; ++e) {
    if (rd32(&cd[p]) != 0x02014b50) return -4;
    uint16_t method = rd16(&cd[p + 10]);
    uint32_t csize = rd32(&cd[p + 20]);
    uint32_t usize = rd32(&cd[p + 24]);
    uint16_t nlen = rd16(&cd[p + 28]);
    uint16_t xlen = rd16(&cd[p + 30]);
    uint16_t clen = rd16(&cd[p + 32]);
    uint32_t lho = rd32(&cd[p + 42]);
    std::string name((const char*)&cd[p + 46], nlen);
    if (name == want1 || name == key) {
      // local header: 30 fixed bytes + name + extra (may differ from CD)
      unsigned char lh[30];
      if (fseek(f, lho, SEEK_SET) != 0) return -1;
      if (fread(lh, 1, 30, f) != 30) return -1;
      if (rd32(lh) != 0x04034b50) return -4;
      uint16_t lnlen = rd16(&lh[26]);
      uint16_t lxlen = rd16(&lh[28]);
      out->data_offset = (uint64_t)lho + 30 + lnlen + lxlen;
      out->comp_size = csize;
      out->uncomp_size = usize;
      out->method = method;
      return 0;
    }
    p += 46 + nlen + xlen + clen;
  }
  return -2;
}

// Parse the npy header at `off`; returns payload offset or <0.
long parse_npy(FILE* f, uint64_t off, long* shape, int* ndim, char* dtype) {
  unsigned char hdr[12];
  if (fseek(f, off, SEEK_SET) != 0) return -1;
  if (fread(hdr, 1, 10, f) != 10) return -1;
  if (memcmp(hdr, "\x93NUMPY", 6) != 0) return -4;
  int major = hdr[6];
  uint32_t hlen;
  uint64_t body;
  if (major == 1) {
    hlen = rd16(&hdr[8]);
    body = off + 10;
  } else {
    if (fread(hdr + 10, 1, 2, f) != 2) return -1;
    hlen = rd32(&hdr[8]);
    body = off + 12;
  }
  std::vector<char> h(hlen + 1, 0);
  if (fseek(f, body, SEEK_SET) != 0) return -1;
  if (fread(h.data(), 1, hlen, f) != hlen) return -1;
  std::string s(h.data());
  // descr
  size_t dp = s.find("'descr'");
  if (dp == std::string::npos) return -4;
  size_t q1 = s.find('\'', dp + 7);  // opening quote of the descr value
  size_t q2 = s.find('\'', q1 + 1);  // closing quote
  if (q1 == std::string::npos || q2 == std::string::npos) return -4;
  std::string descr = s.substr(q1 + 1, q2 - q1 - 1);
  strncpy(dtype, descr.c_str(), 7);
  dtype[7] = 0;
  // fortran_order must be False (C layout)
  if (s.find("'fortran_order': True") != std::string::npos) return -4;
  // shape
  size_t sp = s.find("'shape'");
  size_t o1 = s.find('(', sp);
  size_t o2 = s.find(')', o1);
  if (o1 == std::string::npos || o2 == std::string::npos) return -4;
  std::string tup = s.substr(o1 + 1, o2 - o1 - 1);
  int nd = 0;
  const char* c = tup.c_str();
  while (*c && nd < 8) {
    while (*c == ' ' || *c == ',') ++c;
    if (!*c) break;
    long v = strtol(c, (char**)&c, 10);
    shape[nd++] = v;
  }
  *ndim = nd;
  return (long)(body + hlen);
}

// Inflate a DEFLATE-compressed member into memory.  max_out == 0 inflates
// the full member; max_out > 0 stops after that many output bytes (probe
// only needs the npy header, not the payload).
int inflate_member(FILE* f, const Member& m, std::vector<unsigned char>* out,
                   size_t max_out = 0) {
  std::vector<unsigned char> comp(m.comp_size);
  if (fseek(f, m.data_offset, SEEK_SET) != 0) return -1;
  if (fread(comp.data(), 1, m.comp_size, f) != m.comp_size) return -1;
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -MAX_WBITS) != Z_OK) return -4;  // raw deflate
  zs.next_in = comp.data();
  zs.avail_in = (uInt)comp.size();
  out->resize(max_out ? max_out
                      : std::max<size_t>(comp.size() * 4, 1 << 16));
  int ret;
  size_t written = 0;
  do {
    if (written == out->size()) {
      if (max_out) break;  // header cap reached — enough for the probe
      out->resize(out->size() * 2);
    }
    zs.next_out = out->data() + written;
    zs.avail_out = (uInt)(out->size() - written);
    ret = inflate(&zs, Z_NO_FLUSH);
    if (ret != Z_OK && ret != Z_STREAM_END) { inflateEnd(&zs); return -4; }
    written = out->size() - zs.avail_out;
  } while (ret != Z_STREAM_END);
  inflateEnd(&zs);
  out->resize(written);
  return 0;
}

// Parse npy header from an in-memory buffer; returns payload offset or <0.
long parse_npy_mem(const unsigned char* buf, size_t len, long* shape,
                   int* ndim, char* dtype) {
  if (len < 12 || memcmp(buf, "\x93NUMPY", 6) != 0) return -4;
  int major = buf[6];
  uint32_t hlen;
  size_t body;
  if (major == 1) { hlen = rd16(&buf[8]); body = 10; }
  else { hlen = rd32(&buf[8]); body = 12; }
  if (body + hlen > len) return -4;
  std::string s((const char*)buf + body, hlen);
  size_t dp = s.find("'descr'");
  if (dp == std::string::npos) return -4;
  size_t q1 = s.find('\'', dp + 7);
  size_t q2 = s.find('\'', q1 + 1);
  if (q1 == std::string::npos || q2 == std::string::npos) return -4;
  std::string descr = s.substr(q1 + 1, q2 - q1 - 1);
  strncpy(dtype, descr.c_str(), 7);
  dtype[7] = 0;
  if (s.find("'fortran_order': True") != std::string::npos) return -4;
  size_t sp = s.find("'shape'");
  size_t o1 = s.find('(', sp);
  size_t o2 = s.find(')', o1);
  if (o1 == std::string::npos || o2 == std::string::npos) return -4;
  std::string tup = s.substr(o1 + 1, o2 - o1 - 1);
  int nd = 0;
  const char* c = tup.c_str();
  while (*c && nd < 8) {
    while (*c == ' ' || *c == ',') ++c;
    if (!*c) break;
    shape[nd++] = strtol(c, (char**)&c, 10);
  }
  *ndim = nd;
  return (long)(body + hlen);
}

int read_one(const char* path, const char* key, void* out, long out_cap,
             long* shape, int* ndim, char* dtype, long* nbytes) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  Member m;
  int rc = find_member(f, key, &m);
  if (rc != 0) { fclose(f); return rc; }
  if (m.method == 8) {  // DEFLATE (savez_compressed): inflate then parse
    std::vector<unsigned char> raw;
    if (!out) {
      // probe: inflate only enough for the npy header (v1 headers are
      // <= 64KB+10); payload size comes from the central directory's
      // uncompressed size — avoids decompressing the member twice per
      // probe+read pair
      rc = inflate_member(f, m, &raw, (1 << 16) + 64);
      fclose(f);
      if (rc != 0) return rc;
      long payload = parse_npy_mem(raw.data(), raw.size(), shape, ndim,
                                   dtype);
      if (payload < 0) return (int)payload;
      if (nbytes) *nbytes = (long)(m.uncomp_size - (uint64_t)payload);
      return 0;
    }
    rc = inflate_member(f, m, &raw);
    fclose(f);
    if (rc != 0) return rc;
    long payload = parse_npy_mem(raw.data(), raw.size(), shape, ndim, dtype);
    if (payload < 0) return (int)payload;
    long data_bytes = (long)(raw.size() - payload);
    if (nbytes) *nbytes = data_bytes;
    if (data_bytes > out_cap) return -5;
    memcpy(out, raw.data() + payload, data_bytes);
    return 0;
  }
  if (m.method != 0) { fclose(f); return -3; }
  long payload = parse_npy(f, m.data_offset, shape, ndim, dtype);
  if (payload < 0) { fclose(f); return (int)payload; }
  long data_bytes = (long)(m.comp_size - (payload - (long)m.data_offset));
  if (nbytes) *nbytes = data_bytes;
  if (out) {
    if (data_bytes > out_cap) { fclose(f); return -5; }
    if (fseek(f, payload, SEEK_SET) != 0) { fclose(f); return -1; }
    if (fread(out, 1, data_bytes, f) != (size_t)data_bytes) {
      fclose(f);
      return -1;
    }
  }
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// mmap multi-key fast path (v2).  One open+mmap+central-directory parse per
// file serves EVERY requested key: the CALVIN window load pulls 4 keys per
// frame, which under the v1 API costs 8 opens/file (probe+read per key).
// STORED payloads memcpy straight out of the page cache; DEFLATE members
// inflate from the mapping without a staging read.
// ---------------------------------------------------------------------------

struct Mapped {
  int fd = -1;
  const unsigned char* base = nullptr;
  size_t size = 0;
};

int map_file(const char* path, Mapped* m) {
  m->fd = open(path, O_RDONLY);
  if (m->fd < 0) return -1;
  struct stat st;
  if (fstat(m->fd, &st) != 0 || st.st_size <= 0) {
    close(m->fd);
    m->fd = -1;
    return -1;
  }
  void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, m->fd, 0);
  if (p == MAP_FAILED) {
    close(m->fd);
    m->fd = -1;
    return -1;
  }
  madvise(p, st.st_size, MADV_WILLNEED);
  m->base = (const unsigned char*)p;
  m->size = st.st_size;
  return 0;
}

void unmap_file(Mapped* m) {
  if (m->base) munmap((void*)m->base, m->size);
  if (m->fd >= 0) close(m->fd);
  m->base = nullptr;
  m->fd = -1;
}

// Walk the central directory once, filling members[k] for each keys[k]
// (matched as "key.npy" or "key").  Returns 0 iff every key was found.
int find_members_mem(const Mapped& m, const char* const* keys, int nkeys,
                     Member* members) {
  if (m.size < 22) return -4;
  size_t scan = m.size < 66000 ? m.size : 66000;
  const unsigned char* tail = m.base + (m.size - scan);
  long eocd = -1;
  for (long i = (long)scan - 22; i >= 0; --i) {
    if (rd32(tail + i) == 0x06054b50) { eocd = i; break; }
  }
  if (eocd < 0) return -4;
  uint16_t n_entries = rd16(tail + eocd + 10);
  uint32_t cd_size = rd32(tail + eocd + 12);
  uint32_t cd_off = rd32(tail + eocd + 16);
  if ((uint64_t)cd_off + cd_size > m.size) return -4;
  const unsigned char* cd = m.base + cd_off;

  std::vector<int> found(nkeys, 0);
  int n_found = 0;
  size_t p = 0;
  for (int e = 0; e < n_entries && p + 46 <= cd_size; ++e) {
    if (rd32(cd + p) != 0x02014b50) return -4;
    uint16_t method = rd16(cd + p + 10);
    uint32_t csize = rd32(cd + p + 20);
    uint32_t usize = rd32(cd + p + 24);
    uint16_t nlen = rd16(cd + p + 28);
    uint16_t xlen = rd16(cd + p + 30);
    uint16_t clen = rd16(cd + p + 32);
    uint32_t lho = rd32(cd + p + 42);
    const char* name = (const char*)(cd + p + 46);
    for (int k = 0; k < nkeys; ++k) {
      if (found[k]) continue;
      size_t klen = strlen(keys[k]);
      bool plain = nlen == klen && memcmp(name, keys[k], klen) == 0;
      bool npy = nlen == klen + 4 && memcmp(name, keys[k], klen) == 0 &&
                 memcmp(name + klen, ".npy", 4) == 0;
      if (!plain && !npy) continue;
      if ((uint64_t)lho + 30 > m.size) return -4;
      const unsigned char* lh = m.base + lho;
      if (rd32(lh) != 0x04034b50) return -4;
      uint16_t lnlen = rd16(lh + 26);
      uint16_t lxlen = rd16(lh + 28);
      members[k].data_offset = (uint64_t)lho + 30 + lnlen + lxlen;
      members[k].comp_size = csize;
      members[k].uncomp_size = usize;
      members[k].method = method;
      found[k] = 1;
      if (++n_found == nkeys) return 0;
      break;
    }
    p += 46 + nlen + xlen + clen;
  }
  return -2;
}

// Inflate a DEFLATE member straight from the mapping.
int inflate_mem(const unsigned char* comp, size_t csize,
                std::vector<unsigned char>* out, size_t max_out = 0) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -MAX_WBITS) != Z_OK) return -4;
  zs.next_in = (Bytef*)comp;
  zs.avail_in = (uInt)csize;
  out->resize(max_out ? max_out : std::max<size_t>(csize * 4, 1 << 16));
  int ret;
  size_t written = 0;
  do {
    if (written == out->size()) {
      if (max_out) break;
      out->resize(out->size() * 2);
    }
    zs.next_out = out->data() + written;
    zs.avail_out = (uInt)(out->size() - written);
    ret = inflate(&zs, Z_NO_FLUSH);
    if (ret != Z_OK && ret != Z_STREAM_END) { inflateEnd(&zs); return -4; }
    written = out->size() - zs.avail_out;
  } while (ret != Z_STREAM_END);
  inflateEnd(&zs);
  out->resize(written);
  return 0;
}

// Serve one key from a mapped file.  out == nullptr probes only.
int read_key_mapped(const Mapped& m, const Member& mem, void* out,
                    long out_cap, long* shape, int* ndim, char* dtype,
                    long* nbytes) {
  if (mem.data_offset + mem.comp_size > m.size) return -4;
  const unsigned char* payload = m.base + mem.data_offset;
  if (mem.method == 8) {
    std::vector<unsigned char> raw;
    size_t cap = out ? 0 : (1 << 16) + 64;  // probe: header only
    int rc = inflate_mem(payload, mem.comp_size, &raw, cap);
    if (rc != 0) return rc;
    long off = parse_npy_mem(raw.data(), raw.size(), shape, ndim, dtype);
    if (off < 0) return (int)off;
    long data_bytes = (long)(mem.uncomp_size - (uint64_t)off);
    if (nbytes) *nbytes = data_bytes;
    if (out) {
      if (data_bytes > out_cap) return -5;
      memcpy(out, raw.data() + off, data_bytes);
    }
    return 0;
  }
  if (mem.method != 0) return -3;
  long off = parse_npy_mem(payload, mem.comp_size, shape, ndim, dtype);
  if (off < 0) return (int)off;
  long data_bytes = (long)(mem.comp_size - off);
  if (nbytes) *nbytes = data_bytes;
  if (out) {
    if (data_bytes > out_cap) return -5;
    memcpy(out, payload + off, data_bytes);
  }
  return 0;
}

}  // namespace

extern "C" {

int npz_probe(const char* path, const char* key, long* shape, int* ndim,
              char* dtype, long* nbytes) {
  return read_one(path, key, nullptr, 0, shape, ndim, dtype, nbytes);
}

int npz_read(const char* path, const char* key, void* out, long out_cap) {
  long shape[8];
  int ndim;
  char dtype[8];
  long nbytes;
  return read_one(path, key, out, out_cap, shape, &ndim, dtype, &nbytes);
}

// Threaded batch read: n files, same key, identical array byte size.
int npz_read_many(const char** paths, int n, const char* key, void* out,
                  long item_nbytes, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::vector<int> rcs(n, 0);
  auto worker = [&](int tid) {
    long shape[8];
    int ndim;
    char dtype[8];
    long nbytes;
    for (int i = tid; i < n; i += n_threads) {
      rcs[i] = read_one(paths[i], key,
                        (char*)out + (int64_t)i * item_nbytes, item_nbytes,
                        shape, &ndim, dtype, &nbytes);
      if (rcs[i] == 0 && nbytes != item_nbytes) rcs[i] = -5;
    }
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads; ++t) ts.emplace_back(worker, t);
  for (auto& t : ts) t.join();
  for (int i = 0; i < n; ++i)
    if (rcs[i] != 0) return rcs[i];
  return 0;
}

// -- v2 mmap multi-key ABI ---------------------------------------------------

// Probe every key of one file in a single mmap + directory parse.
// shapes: nkeys*8 longs; ndims/nbytes: nkeys; dtypes: nkeys*8 chars.
int npz_probe_keys(const char* path, const char** keys, int nkeys,
                   long* shapes, int* ndims, char* dtypes, long* nbytes) {
  Mapped m;
  if (map_file(path, &m) != 0) return -1;
  std::vector<Member> mem(nkeys);
  int rc = find_members_mem(m, keys, nkeys, mem.data());
  if (rc == 0) {
    for (int k = 0; k < nkeys; ++k) {
      rc = read_key_mapped(m, mem[k], nullptr, 0, shapes + 8 * k, ndims + k,
                           dtypes + 8 * k, nbytes + k);
      if (rc != 0) break;
    }
  }
  unmap_file(&m);
  return rc;
}

// Threaded window read of nkeys arrays from each of nfiles members-identical
// frame files: file i's key k lands at outs[k] + i * item_nbytes[k].
// One mmap + one central-directory parse per FILE (not per key).
int npz_window_read_keys(const char** paths, int nfiles, const char** keys,
                         int nkeys, void** outs, const long* item_nbytes,
                         int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > nfiles) n_threads = nfiles;
  std::vector<int> rcs(nfiles, 0);
  auto worker = [&](int tid) {
    long shape[8];
    int ndim;
    char dtype[8];
    long nbytes;
    std::vector<Member> mem(nkeys);
    for (int i = tid; i < nfiles; i += n_threads) {
      Mapped m;
      if (map_file(paths[i], &m) != 0) { rcs[i] = -1; continue; }
      madvise((void*)m.base, m.size, MADV_SEQUENTIAL);
      int rc = find_members_mem(m, keys, nkeys, mem.data());
      for (int k = 0; rc == 0 && k < nkeys; ++k) {
        rc = read_key_mapped(m, mem[k],
                             (char*)outs[k] + (int64_t)i * item_nbytes[k],
                             item_nbytes[k], shape, &ndim, dtype, &nbytes);
        if (rc == 0 && nbytes != item_nbytes[k]) rc = -5;
      }
      unmap_file(&m);
      rcs[i] = rc;
    }
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads; ++t) ts.emplace_back(worker, t);
  for (auto& t : ts) t.join();
  for (int i = 0; i < nfiles; ++i)
    if (rcs[i] != 0) return rcs[i];
  return 0;
}

}  // extern "C"

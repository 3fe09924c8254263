// Native octomap .bt / PCL .pcd codec.
//
// Host-side replacement for the octomap + PCL C++ dependencies of the
// reference's map-building workflow (plugin_build_octomap.cpp:104-146 writes
// both formats; publish_pointcloud.cpp:16-62 reads .pcd). Implements the
// octomap "OcTree binary file" (.bt) encoding — a depth-first 2-bit-per-child
// stream — so the reference's shipped ground-truth maps (poles.bt, poles.pcd)
// load bit-exactly, and our generated worlds can be exported back for
// octomap-based consumers.
//
// Exposed as a plain C ABI consumed via ctypes (io/octomap.py). Build:
//   g++ -O2 -shared -fPIC -o liboctomap_codec.so octomap_codec.cc

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

namespace {

constexpr int kTreeDepth = 16;  // octomap default tree depth

struct Leaf {
  float cx, cy, cz;
  float half;  // half edge length
  uint8_t occupied;
};

struct BtHandle {
  double res = 0.1;
  std::vector<Leaf> leaves;
};

struct PcdHandle {
  std::vector<float> xyz;  // 3 * n
};

// .bt child semantics (octomap OccupancyOcTreeBase binary encoding):
//   00 unknown/absent, 01 free leaf, 10 occupied leaf, 11 inner node
void DecodeNode(std::istream& in, double cx, double cy, double cz, double size,
                int depth, BtHandle* out) {
  unsigned char b[2];
  in.read(reinterpret_cast<char*>(b), 2);
  if (!in) return;
  int codes[8];
  for (int i = 0; i < 4; ++i) codes[i] = (b[0] >> (2 * i)) & 3;
  for (int i = 0; i < 4; ++i) codes[4 + i] = (b[1] >> (2 * i)) & 3;

  const double off = size / 4.0;
  for (int i = 0; i < 8; ++i) {
    if (codes[i] == 0) continue;
    const double ccx = cx + ((i & 1) ? off : -off);
    const double ccy = cy + ((i & 2) ? off : -off);
    const double ccz = cz + ((i & 4) ? off : -off);
    if (codes[i] == 3) {
      if (depth + 1 < kTreeDepth) {
        DecodeNode(in, ccx, ccy, ccz, size / 2.0, depth + 1, out);
      }
    } else {
      Leaf leaf;
      leaf.cx = static_cast<float>(ccx);
      leaf.cy = static_cast<float>(ccy);
      leaf.cz = static_cast<float>(ccz);
      leaf.half = static_cast<float>(size / 4.0);
      leaf.occupied = (codes[i] == 2) ? 1 : 0;
      out->leaves.push_back(leaf);
    }
  }
}

// Recursive .bt writer over a dense occupancy grid. Returns the 2-bit code of
// the node covering the given cube: 0 unknown (entirely outside the grid),
// 1 occupied leaf, 2 free leaf, 3 inner (children follow in `stream`).
struct GridView {
  const uint8_t* grid;
  int nx, ny, nz;
  double res, ox, oy, oz;
};

// classify cube [lo, hi) against the grid: -1 mixed, 0 outside, 1 all
// occupied, 2 all free
int ClassifyCube(const GridView& g, double cx, double cy, double cz,
                 double size) {
  const double h = size / 2.0;
  // convert to cell ranges (clamped)
  auto cell = [](double w, double origin, double res) {
    return static_cast<long>(std::floor((w - origin) / res + 1e-9));
  };
  long x0 = cell(cx - h, g.ox, g.res), x1 = cell(cx + h, g.ox, g.res);
  long y0 = cell(cy - h, g.oy, g.res), y1 = cell(cy + h, g.oy, g.res);
  long z0 = cell(cz - h, g.oz, g.res), z1 = cell(cz + h, g.oz, g.res);
  if (x1 <= 0 || y1 <= 0 || z1 <= 0 || x0 >= g.nx || y0 >= g.ny || z0 >= g.nz)
    return 0;  // fully outside
  const bool clipped = x0 < 0 || y0 < 0 || z0 < 0 || x1 > g.nx || y1 > g.ny ||
                       z1 > g.nz;
  long cx0 = std::max(x0, 0L), cx1 = std::min(x1, (long)g.nx);
  long cy0 = std::max(y0, 0L), cy1 = std::min(y1, (long)g.ny);
  long cz0 = std::max(z0, 0L), cz1 = std::min(z1, (long)g.nz);
  bool any_occ = false, any_free = false;
  for (long z = cz0; z < cz1 && !(any_occ && any_free); ++z)
    for (long y = cy0; y < cy1 && !(any_occ && any_free); ++y)
      for (long x = cx0; x < cx1; ++x) {
        if (g.grid[(z * g.ny + y) * g.nx + x])
          any_occ = true;
        else
          any_free = true;
        if (any_occ && any_free) break;
      }
  if (any_occ && any_free) return -1;
  if (clipped) {
    // partially outside: outside region is unknown -> only a pure-free or
    // pure-occupied *full* cube may become a leaf; treat clipped cubes with a
    // single state as free/occupied leaves anyway (octomap's maps treat
    // unknown as unmapped; collapsing to the known state keeps files small
    // and matches how the reference's plugin marks unknown-as-occupied
    // *inside* the bounding box only).
    return any_occ ? 1 : 2;
  }
  return any_occ ? 1 : 2;
}

void EncodeChildren(const GridView& g, double cx, double cy, double cz,
                    double size, int depth, std::string* stream) {
  const double off = size / 4.0;
  unsigned char b[2] = {0, 0};
  int codes[8];
  for (int i = 0; i < 8; ++i) {
    const double ccx = cx + ((i & 1) ? off : -off);
    const double ccy = cy + ((i & 2) ? off : -off);
    const double ccz = cz + ((i & 4) ? off : -off);
    int cls = ClassifyCube(g, ccx, ccy, ccz, size / 2.0);
    int code;
    if (cls == 0)
      code = 0;
    else if (cls == 1)
      code = 2;  // occupied
    else if (cls == 2)
      code = 1;  // free
    else
      code = (depth + 1 >= kTreeDepth) ? 2 : 3;  // mixed at max depth: occupied
    codes[i] = code;
    if (i < 4)
      b[0] |= code << (2 * i);
    else
      b[1] |= code << (2 * (i - 4));
  }
  stream->push_back(static_cast<char>(b[0]));
  stream->push_back(static_cast<char>(b[1]));
  for (int i = 0; i < 8; ++i) {
    if (codes[i] == 3) {
      const double ccx = cx + ((i & 1) ? off : -off);
      const double ccy = cy + ((i & 2) ? off : -off);
      const double ccz = cz + ((i & 4) ? off : -off);
      EncodeChildren(g, ccx, ccy, ccz, size / 2.0, depth + 1, stream);
    }
  }
}

long CountNodes(const std::string& stream) {
  // every 2 bytes is one inner node; leaves are implicit. octomap's `size`
  // header counts all nodes (inner + leaves).
  long inner = stream.size() / 2;
  long leaves = 0;
  for (size_t i = 0; i < stream.size(); ++i) {
    unsigned char byte = static_cast<unsigned char>(stream[i]);
    for (int k = 0; k < 4; ++k) {
      int code = (byte >> (2 * k)) & 3;
      if (code == 1 || code == 2) ++leaves;
    }
  }
  return inner + leaves;
}

}  // namespace

extern "C" {

void* bt_read(const char* path, int* n_leaves, double* res_out) {
  std::ifstream in(path, std::ios::binary);
  if (!in) return nullptr;
  std::string line;
  double res = 0.1;
  bool ok_id = false;
  while (std::getline(in, line)) {
    if (line.rfind("# Octomap OcTree", 0) == 0) continue;
    if (line.empty() || line[0] == '#') continue;
    if (line.rfind("id ", 0) == 0) {
      ok_id = (line.substr(3) == "OcTree");
    } else if (line.rfind("res ", 0) == 0) {
      res = std::stod(line.substr(4));
    } else if (line.rfind("size ", 0) == 0) {
      // node count; informational
    } else if (line == "data") {
      break;
    }
  }
  if (!ok_id) return nullptr;
  auto* h = new BtHandle;
  h->res = res;
  const double root_size = res * (1 << kTreeDepth);
  DecodeNode(in, 0.0, 0.0, 0.0, root_size, 0, h);
  *n_leaves = static_cast<int>(h->leaves.size());
  *res_out = res;
  return h;
}

void bt_get_leaves(void* handle, float* centers, float* half_sizes,
                   uint8_t* occupied) {
  auto* h = static_cast<BtHandle*>(handle);
  for (size_t i = 0; i < h->leaves.size(); ++i) {
    centers[3 * i + 0] = h->leaves[i].cx;
    centers[3 * i + 1] = h->leaves[i].cy;
    centers[3 * i + 2] = h->leaves[i].cz;
    half_sizes[i] = h->leaves[i].half;
    occupied[i] = h->leaves[i].occupied;
  }
}

void bt_free(void* handle) { delete static_cast<BtHandle*>(handle); }

int bt_write(const char* path, const uint8_t* grid, int nx, int ny, int nz,
             double res, double ox, double oy, double oz) {
  GridView g{grid, nx, ny, nz, res, ox, oy, oz};
  const double root_size = res * (1 << kTreeDepth);
  std::string stream;
  int root_cls = ClassifyCube(g, 0, 0, 0, root_size);
  if (root_cls == -1 || root_cls == 1 || root_cls == 2) {
    EncodeChildren(g, 0, 0, 0, root_size, 0, &stream);
  }
  std::ofstream out(path, std::ios::binary);
  if (!out) return -1;
  out << "# Octomap OcTree binary file\n"
      << "# (feel free to add / change comments, but leave the first line as "
         "it is!)\n#\n"
      << "id OcTree\n"
      << "size " << CountNodes(stream) + 1 << "\n"
      << "res " << res << "\ndata\n";
  out.write(stream.data(), static_cast<std::streamsize>(stream.size()));
  return 0;
}

void* pcd_read(const char* path, int* n_points) {
  std::ifstream in(path, std::ios::binary);
  if (!in) return nullptr;
  std::string line;
  long points = 0;
  bool binary = false;
  int fields = 3;
  while (std::getline(in, line)) {
    if (line.rfind("FIELDS", 0) == 0) {
      fields = 0;
      std::istringstream ss(line.substr(6));
      std::string f;
      while (ss >> f) ++fields;
    } else if (line.rfind("POINTS", 0) == 0) {
      points = std::stol(line.substr(7));
    } else if (line.rfind("DATA", 0) == 0) {
      binary = line.find("binary") != std::string::npos;
      break;
    }
  }
  auto* h = new PcdHandle;
  h->xyz.reserve(3 * points);
  if (binary) {
    std::vector<float> row(fields);
    for (long i = 0; i < points; ++i) {
      in.read(reinterpret_cast<char*>(row.data()), fields * sizeof(float));
      if (!in) break;
      h->xyz.push_back(row[0]);
      h->xyz.push_back(row[1]);
      h->xyz.push_back(row[2]);
    }
  } else {
    for (long i = 0; i < points && std::getline(in, line); ++i) {
      std::istringstream ss(line);
      float x, y, z;
      ss >> x >> y >> z;
      h->xyz.push_back(x);
      h->xyz.push_back(y);
      h->xyz.push_back(z);
    }
  }
  *n_points = static_cast<int>(h->xyz.size() / 3);
  return h;
}

void pcd_get_points(void* handle, float* xyz) {
  auto* h = static_cast<PcdHandle*>(handle);
  std::memcpy(xyz, h->xyz.data(), h->xyz.size() * sizeof(float));
}

void pcd_free(void* handle) { delete static_cast<PcdHandle*>(handle); }

int pcd_write(const char* path, const float* xyz, int n, int ascii_mode) {
  std::ofstream out(path, std::ios::binary);
  if (!out) return -1;
  out << "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
      << "FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
      << "WIDTH " << n << "\nHEIGHT 1\nVIEWPOINT 0 0 0 0 0 0 1\n"
      << "POINTS " << n << "\nDATA " << (ascii_mode ? "ascii" : "binary")
      << "\n";
  if (ascii_mode) {
    char buf[128];
    for (int i = 0; i < n; ++i) {
      std::snprintf(buf, sizeof(buf), "%g %g %g\n", xyz[3 * i], xyz[3 * i + 1],
                    xyz[3 * i + 2]);
      out << buf;
    }
  } else {
    out.write(reinterpret_cast<const char*>(xyz),
              static_cast<std::streamsize>(3L * n * sizeof(float)));
  }
  return 0;
}

}  // extern "C"

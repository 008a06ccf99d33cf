// LD06 LiDAR ingest: stream packet parser + ToF band filter + scan
// assembler, C++ with a C ABI for ctypes.
//
// Native-equivalent of the reference's vendored ldlidar_stl_ros2 driver
// pipeline (SURVEY.md §2.3): serial bytes -> lipkg packet parse ->
// tofbf filter -> LaserScan assembly (`pi/build/
// ldlidar_stl_ros2/CMakeFiles/.../link.txt` TU list). Re-designed, not
// translated: a single resync-tolerant ring parser feeding a beam-indexed
// rotation accumulator, so the Python side receives fixed-shape arrays
// ready for device padding.
//
// LD06 wire format (public ldrobot datasheet): 47-byte packet
//   [0]  0x54 header
//   [1]  0x2C ver_len (12 points)
//   [2:4]   speed, deg/s, LE
//   [4:6]   start angle, 0.01 deg, LE
//   [6:42]  12 x { distance mm (2B LE), confidence (1B) }
//   [42:44] end angle, 0.01 deg, LE
//   [44:46] timestamp ms, LE
//   [46] CRC8 over bytes [0:46]
//
// Build: g++ -O2 -std=c++17 -shared -fPIC ld06.cpp -o libld06.so

#include <cstdint>
#include <cstring>
#include <deque>
#include <vector>

namespace {

constexpr uint8_t kHeader = 0x54;
constexpr uint8_t kVerLen = 0x2C;
constexpr int kPacketBytes = 47;
constexpr int kPointsPerPacket = 12;

// CRC8, poly 0x4D, init 0 (ldrobot reference implementation's table
// parameters; table generated at startup rather than pasted).
struct Crc8Table {
  uint8_t t[256];
  Crc8Table() {
    for (int i = 0; i < 256; ++i) {
      uint8_t crc = static_cast<uint8_t>(i);
      for (int b = 0; b < 8; ++b)
        crc = (crc & 0x80) ? static_cast<uint8_t>((crc << 1) ^ 0x4D)
                           : static_cast<uint8_t>(crc << 1);
      t[i] = crc;
    }
  }
};
const Crc8Table kCrc;

uint8_t crc8(const uint8_t* data, int len) {
  uint8_t crc = 0;
  for (int i = 0; i < len; ++i) crc = kCrc.t[(crc ^ data[i]) & 0xFF];
  return crc;
}

uint16_t le16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0] | (p[1] << 8));
}

struct Point {
  float angle_deg;    // [0, 360)
  float dist_m;       // 0 = no return
  uint8_t confidence;
};

struct Stats {
  long packets = 0;
  long crc_errors = 0;
  long resyncs = 0;
  long points = 0;
  long points_filtered = 0;
  long scans = 0;
};

// ToF band filter (role of the reference driver's tofbf.cpp): reject
// low-confidence returns and isolated range spikes whose neighbours
// disagree by more than a band around the local median.
class TofBandFilter {
 public:
  explicit TofBandFilter(uint8_t min_confidence = 15,
                         float band_m = 0.15f)
      : min_confidence_(min_confidence), band_m_(band_m) {}

  // In-place over one packet's points; neighbours within the packet.
  int apply(std::vector<Point>& pts) const {
    int removed = 0;
    const int n = static_cast<int>(pts.size());
    for (int i = 0; i < n; ++i) {
      Point& p = pts[i];
      if (p.dist_m <= 0.0f) continue;
      if (p.confidence < min_confidence_) {
        p.dist_m = 0.0f;
        ++removed;
        continue;
      }
      // 3-neighbourhood median spike test.
      float a = pts[(i + n - 1) % n].dist_m;
      float b = pts[(i + 1) % n].dist_m;
      if (a > 0.0f && b > 0.0f) {
        float lo = a < b ? a : b, hi = a < b ? b : a;
        if (p.dist_m < lo - band_m_ || p.dist_m > hi + band_m_) {
          // isolated spike only if the neighbours agree with each other
          if (hi - lo < band_m_) {
            p.dist_m = 0.0f;
            ++removed;
          }
        }
      }
    }
    return removed;
  }

 private:
  uint8_t min_confidence_;
  float band_m_;
};

// One full rotation, beam-indexed.
class ScanAssembler {
 public:
  explicit ScanAssembler(int n_beams) : n_beams_(n_beams) {
    reset();
  }

  void reset() {
    ranges_.assign(n_beams_, 0.0f);
    intensities_.assign(n_beams_, 0.0f);
    have_.assign(n_beams_, 0);
    last_angle_ = -1.0f;
    accum_deg_ = 0.0f;
  }

  // Returns true when a rotation completed (caller takes the scan first).
  bool add(const Point& p) {
    bool completed = false;
    if (last_angle_ >= 0.0f) {
      float d = p.angle_deg - last_angle_;
      if (d < -180.0f) d += 360.0f;       // wrapped past 360
      if (d > 0.0f) accum_deg_ += d;
      if (accum_deg_ >= 360.0f) completed = true;
    }
    last_angle_ = p.angle_deg;
    if (completed) return true;           // point belongs to next scan
    int beam = static_cast<int>(p.angle_deg / 360.0f * n_beams_);
    if (beam >= 0 && beam < n_beams_ && p.dist_m > 0.0f) {
      ranges_[beam] = p.dist_m;
      intensities_[beam] = static_cast<float>(p.confidence);
      have_[beam] = 1;
    }
    return false;
  }

  void take(float* ranges_out, float* intens_out) {
    std::memcpy(ranges_out, ranges_.data(), n_beams_ * sizeof(float));
    std::memcpy(intens_out, intensities_.data(), n_beams_ * sizeof(float));
    float carry_a = last_angle_;
    reset();
    last_angle_ = carry_a;
    accum_deg_ = 0.0f;
  }

  int n_beams() const { return n_beams_; }

 private:
  int n_beams_;
  std::vector<float> ranges_, intensities_;
  std::vector<uint8_t> have_;
  float last_angle_;
  float accum_deg_;
};

class Ld06Driver {
 public:
  Ld06Driver(int n_beams, uint8_t min_confidence, float band_m)
      : filter_(min_confidence, band_m), assembler_(n_beams) {}

  int feed(const uint8_t* data, int len) {
    buf_.insert(buf_.end(), data, data + len);
    int new_points = 0;
    while (buf_.size() >= kPacketBytes) {
      if (buf_[0] != kHeader || buf_[1] != kVerLen) {
        buf_.pop_front();
        ++stats_.resyncs;
        continue;
      }
      uint8_t pkt[kPacketBytes];
      for (int i = 0; i < kPacketBytes; ++i) pkt[i] = buf_[i];
      if (crc8(pkt, kPacketBytes - 1) != pkt[kPacketBytes - 1]) {
        buf_.pop_front();                 // bad packet: shift + resync
        ++stats_.crc_errors;
        continue;
      }
      for (int i = 0; i < kPacketBytes; ++i) buf_.pop_front();
      parse_packet(pkt);
      new_points += kPointsPerPacket;
    }
    return new_points;
  }

  bool take_scan(float* ranges_out, float* intens_out, int n_beams) {
    if (!scan_ready_ || n_beams != assembler_.n_beams()) return false;
    std::memcpy(ranges_out, pending_ranges_.data(),
                n_beams * sizeof(float));
    std::memcpy(intens_out, pending_intens_.data(),
                n_beams * sizeof(float));
    scan_ready_ = false;
    return true;
  }

  double speed_deg_s() const { return speed_deg_s_; }

  long stat(int which) const {
    switch (which) {
      case 0: return stats_.packets;
      case 1: return stats_.crc_errors;
      case 2: return stats_.resyncs;
      case 3: return stats_.points;
      case 4: return stats_.points_filtered;
      case 5: return stats_.scans;
      default: return -1;
    }
  }

 private:
  void parse_packet(const uint8_t* pkt) {
    ++stats_.packets;
    speed_deg_s_ = le16(pkt + 2);
    float start = le16(pkt + 4) * 0.01f;
    float end = le16(pkt + 42) * 0.01f;
    float span = end - start;
    if (span < 0.0f) span += 360.0f;
    std::vector<Point> pts(kPointsPerPacket);
    for (int i = 0; i < kPointsPerPacket; ++i) {
      const uint8_t* p = pkt + 6 + i * 3;
      float ang = start + span * i / (kPointsPerPacket - 1);
      if (ang >= 360.0f) ang -= 360.0f;
      pts[i] = {ang, le16(p) * 0.001f, p[2]};
    }
    stats_.points += kPointsPerPacket;
    stats_.points_filtered += filter_.apply(pts);
    for (const Point& p : pts) {
      if (assembler_.add(p)) {
        // Rotation complete: stage the finished scan, then add the point
        // to the fresh one.
        pending_ranges_.assign(assembler_.n_beams(), 0.0f);
        pending_intens_.assign(assembler_.n_beams(), 0.0f);
        assembler_.take(pending_ranges_.data(), pending_intens_.data());
        scan_ready_ = true;
        ++stats_.scans;
        assembler_.add(p);
      }
    }
  }

  std::deque<uint8_t> buf_;
  TofBandFilter filter_;
  ScanAssembler assembler_;
  std::vector<float> pending_ranges_, pending_intens_;
  bool scan_ready_ = false;
  double speed_deg_s_ = 0.0;
  Stats stats_;
};

}  // namespace

extern "C" {

void* ld06_create(int n_beams, int min_confidence, float band_m) {
  return new Ld06Driver(n_beams, static_cast<uint8_t>(min_confidence),
                        band_m);
}

void ld06_destroy(void* h) { delete static_cast<Ld06Driver*>(h); }

int ld06_feed(void* h, const uint8_t* data, int len) {
  return static_cast<Ld06Driver*>(h)->feed(data, len);
}

int ld06_take_scan(void* h, float* ranges_out, float* intens_out,
                   int n_beams) {
  return static_cast<Ld06Driver*>(h)->take_scan(ranges_out, intens_out,
                                                n_beams)
             ? 1
             : 0;
}

double ld06_speed(void* h) {
  return static_cast<Ld06Driver*>(h)->speed_deg_s();
}

long ld06_stat(void* h, int which) {
  return static_cast<Ld06Driver*>(h)->stat(which);
}

}  // extern "C"

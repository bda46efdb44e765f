// Native event-camera RAW decoder: Prophesee EVT2 / EVT3 / DAT -> SoA arrays.
//
// Replaces the reference's dependency on the Metavision SDK RAW reader
// (reference: bias_events_iterator.py:8-9,83-90 uses
// metavision_core.event_io.RawReaderBase) with a standalone C++ decoder
// exposed through a C ABI consumed via ctypes (xmaps/io/evt_decoder.py).
//
// Format references: Prophesee public EVT 2.0 / EVT 3.0 encoding specs.
//   EVT2 (32-bit words):  [31:28] type, CD: [27:22] ts(6b) [21:11] x [10:0] y
//                         TIME_HIGH: [27:0] << 6 us
//   EVT3 (16-bit words):  [15:12] type; ADDR_Y/ADDR_X/VECT_BASE_X/VECT_12/
//                         VECT_8/TIME_LOW/TIME_HIGH/EXT_TRIGGER
//   DAT: header then records of (u32 t_us, u32 packed x/y/p)
//
// The decoder is streaming: evt_decode fills caller-provided SoA buffers and
// keeps state (time bases, vector row state) across calls, so the host feed
// can cut packets at arbitrary boundaries (delta_t packetization happens in
// Python on the decoded i64 timestamps).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>

namespace {

enum Format : int32_t {
  FMT_UNKNOWN = 0,
  FMT_EVT2 = 2,
  FMT_EVT3 = 3,
  FMT_DAT = 4,
};

struct Decoder {
  FILE* f = nullptr;
  Format fmt = FMT_UNKNOWN;
  int32_t width = 0;
  int32_t height = 0;

  // --- shared time state ---
  // EVT2: full ts = (time_high << 6) | ts6, extended to 64 bit.
  // EVT3: full ts = (time_high << 12) | time_low, extended to 64 bit.
  int64_t time_high = -1;    // last seen time-high value (raw, unshifted)
  int64_t time_high_ovf = 0; // number of rollovers observed
  int64_t time_low = 0;

  // --- EVT3 row state ---
  int32_t cur_y = 0;
  int32_t vect_base_x = 0;
  int32_t vect_pol = 0;
  // Partially-emitted vector word: when the caller's capacity fills
  // mid-vector, the un-emitted set bits wait here and are drained at the
  // start of the next call (time/row state cannot change in between
  // because no further words are consumed).  vect_base_x stays
  // un-advanced until the word completes; pend_bits remembers the
  // word's width (12 or 8) for that final advance.
  uint16_t pend_mask = 0;
  int32_t pend_bits = 0;

  // buffered IO
  static constexpr size_t BUF_CAP = 1 << 20;
  uint8_t* buf = nullptr;
  size_t buf_len = 0;   // valid bytes in buf
  size_t buf_pos = 0;   // consumed bytes
  bool eof = false;

  ~Decoder() {
    if (f) fclose(f);
    free(buf);
  }

  bool refill() {
    if (buf_pos < buf_len) {
      memmove(buf, buf + buf_pos, buf_len - buf_pos);
      buf_len -= buf_pos;
    } else {
      buf_len = 0;
    }
    buf_pos = 0;
    if (!eof) {
      size_t n = fread(buf + buf_len, 1, BUF_CAP - buf_len, f);
      buf_len += n;
      if (n == 0) eof = true;
    }
    return buf_len > buf_pos;
  }
};

// Parse the ASCII '%' header; leaves the file positioned at binary data.
// Returns header length. Fills fmt/width/height when present.
int64_t parse_header(FILE* f, Format* fmt, int32_t* w, int32_t* h) {
  int64_t pos = 0;
  char line[4096];
  *fmt = FMT_UNKNOWN;
  for (;;) {
    long start = ftell(f);
    if (!fgets(line, sizeof(line), f)) break;
    if (line[0] != '%') {
      fseek(f, start, SEEK_SET);
      pos = start;
      break;
    }
    pos = ftell(f);
    std::string s(line);
    // "% format EVT2" / "% evt 2.0" / "% evt 3.0" / "% format EVT3;..."
    auto has = [&](const char* sub) { return s.find(sub) != std::string::npos; };
    if (has("format EVT2") || has("evt 2.0") || has("EVT2.0")) *fmt = FMT_EVT2;
    if (has("format EVT21") || has("evt 2.1")) *fmt = FMT_EVT2;  // 2.1 unsupported vectors; best effort
    if (has("format EVT3") || has("evt 3.0")) *fmt = FMT_EVT3;
    if (has("Version 2") && *fmt == FMT_UNKNOWN && has("dat")) *fmt = FMT_DAT;
    size_t g = s.find("geometry ");
    if (g != std::string::npos) {
      int gw = 0, gh = 0;
      if (sscanf(s.c_str() + g + 9, "%dx%d", &gw, &gh) == 2) {
        *w = gw;
        *h = gh;
      }
    }
    if (has("% end")) {
      pos = ftell(f);
      break;
    }
  }
  return pos;
}

}  // namespace

extern "C" {

// Opens a RAW/DAT file. fmt_hint: 0=auto (from header / extension),
// 2=EVT2, 3=EVT3, 4=DAT. Returns nullptr on failure.
void* evt_open(const char* path, int32_t fmt_hint) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* d = new Decoder();
  d->f = f;
  d->buf = static_cast<uint8_t*>(malloc(Decoder::BUF_CAP));
  Format fmt = FMT_UNKNOWN;
  parse_header(f, &fmt, &d->width, &d->height);
  if (fmt_hint != 0) fmt = static_cast<Format>(fmt_hint);
  if (fmt == FMT_UNKNOWN) {
    const char* dot = strrchr(path, '.');
    if (dot && strcmp(dot, ".dat") == 0) fmt = FMT_DAT;
  }
  if (fmt == FMT_DAT) {
    // DAT binary prefix: 1 byte event type, 1 byte event size
    int ev_type = fgetc(f);
    int ev_size = fgetc(f);
    (void)ev_type;
    if (ev_size != 8) { /* still attempt 8-byte records */ }
  }
  if (fmt == FMT_UNKNOWN) fmt = FMT_EVT2;  // Gen3 EVK1 default
  d->fmt = fmt;
  return d;
}

void evt_close(void* h) { delete static_cast<Decoder*>(h); }

int32_t evt_get_width(void* h) { return static_cast<Decoder*>(h)->width; }
int32_t evt_get_height(void* h) { return static_cast<Decoder*>(h)->height; }
int32_t evt_get_format(void* h) { return static_cast<Decoder*>(h)->fmt; }

// Decode up to max_events CD events into SoA buffers.
// Returns the number of events decoded; 0 at EOF.
int64_t evt_decode(void* h, int64_t max_events, uint16_t* xs, uint16_t* ys,
                   int16_t* ps, int64_t* ts) {
  auto* d = static_cast<Decoder*>(h);
  int64_t n = 0;

  if (d->fmt == FMT_EVT2) {
    while (n < max_events) {
      if (d->buf_len - d->buf_pos < 4) {
        if (!d->refill() || d->buf_len - d->buf_pos < 4) break;
      }
      uint32_t w;
      memcpy(&w, d->buf + d->buf_pos, 4);
      d->buf_pos += 4;
      uint32_t type = w >> 28;
      if (type == 0x0 || type == 0x1) {  // CD_OFF / CD_ON
        if (d->time_high < 0) continue;  // no time base yet
        int64_t th = (d->time_high_ovf << 28) | d->time_high;
        int64_t t = (th << 6) | ((w >> 22) & 0x3F);
        uint16_t x = (w >> 11) & 0x7FF;
        uint16_t y = w & 0x7FF;
        xs[n] = x;
        ys[n] = y;
        ps[n] = static_cast<int16_t>(type);
        ts[n] = t;
        n++;
      } else if (type == 0x8) {  // EVT_TIME_HIGH
        int64_t th = w & 0x0FFFFFFF;
        if (d->time_high >= 0 && th < d->time_high &&
            (d->time_high - th) > (1 << 27)) {
          d->time_high_ovf++;  // 28-bit rollover
        }
        d->time_high = th;
      }
      // 0xA EXT_TRIGGER, 0xE OTHERS, 0xF CONTINUED: skipped
    }
    return n;
  }

  if (d->fmt == FMT_EVT3) {
    // Drain a vector word left partially emitted by the previous call.
    if (d->pend_mask) {
      int64_t th = (d->time_high_ovf << 12) + d->time_high;
      int64_t t = (th << 12) | d->time_low;
      for (int i = 0; i < d->pend_bits; i++) {
        if (!(d->pend_mask & (1u << i))) continue;
        if (n >= max_events) return n;  // still not done; keep the rest
        xs[n] = static_cast<uint16_t>(d->vect_base_x + i);
        ys[n] = static_cast<uint16_t>(d->cur_y);
        ps[n] = static_cast<int16_t>(d->vect_pol);
        ts[n] = t;
        n++;
        d->pend_mask = static_cast<uint16_t>(d->pend_mask & ~(1u << i));
      }
      d->vect_base_x += d->pend_bits;
      d->pend_bits = 0;
    }
    while (n < max_events) {
      if (d->buf_len - d->buf_pos < 2) {
        if (!d->refill() || d->buf_len - d->buf_pos < 2) break;
      }
      uint16_t w;
      memcpy(&w, d->buf + d->buf_pos, 2);
      d->buf_pos += 2;
      uint16_t type = w >> 12;
      switch (type) {
        case 0x0:  // EVT_ADDR_Y
          d->cur_y = w & 0x7FF;
          break;
        case 0x2: {  // EVT_ADDR_X: single event
          if (d->time_high < 0) break;
          int64_t th = (d->time_high_ovf << 12) + d->time_high;
          int64_t t = (th << 12) | d->time_low;
          xs[n] = w & 0x7FF;
          ys[n] = static_cast<uint16_t>(d->cur_y);
          ps[n] = (w >> 11) & 1;
          ts[n] = t;
          n++;
          break;
        }
        case 0x3:  // VECT_BASE_X
          d->vect_pol = (w >> 11) & 1;
          d->vect_base_x = w & 0x7FF;
          break;
        case 0x4:    // VECT_12
        case 0x5: {  // VECT_8
          int bits = (type == 0x4) ? 12 : 8;
          uint16_t mask = w & ((1u << bits) - 1);
          if (d->time_high >= 0) {
            int64_t th = (d->time_high_ovf << 12) + d->time_high;
            int64_t t = (th << 12) | d->time_low;
            for (int i = 0; i < bits; i++) {
              if (!(mask & (1u << i))) continue;
              if (n >= max_events) {
                // Capacity filled mid-vector: park the un-emitted bits
                // (the drain at the top of the next call finishes the
                // word; works for ANY capacity, including capacities
                // smaller than the word's popcount).
                d->pend_mask =
                    static_cast<uint16_t>(mask & ~((1u << i) - 1));
                d->pend_bits = bits;
                return n;
              }
              xs[n] = static_cast<uint16_t>(d->vect_base_x + i);
              ys[n] = static_cast<uint16_t>(d->cur_y);
              ps[n] = static_cast<int16_t>(d->vect_pol);
              ts[n] = t;
              n++;
            }
          }
          d->vect_base_x += bits;
          break;
        }
        case 0x6:  // EVT_TIME_LOW
          d->time_low = w & 0xFFF;
          break;
        case 0x8: {  // EVT_TIME_HIGH
          int64_t th = w & 0xFFF;
          if (d->time_high >= 0 && th < d->time_high &&
              (d->time_high - th) > (1 << 11)) {
            d->time_high_ovf++;
          }
          d->time_high = th;
          // per spec, TIME_HIGH combines with the LAST received TIME_LOW;
          // the low bits are not reset here.
          break;
        }
        default:
          break;  // EXT_TRIGGER / OTHERS / CONTINUED ignored
      }
    }
    return n;
  }

  if (d->fmt == FMT_DAT) {
    while (n < max_events) {
      if (d->buf_len - d->buf_pos < 8) {
        if (!d->refill() || d->buf_len - d->buf_pos < 8) break;
      }
      uint32_t t32, data;
      memcpy(&t32, d->buf + d->buf_pos, 4);
      memcpy(&data, d->buf + d->buf_pos + 4, 4);
      d->buf_pos += 8;
      xs[n] = data & 0x3FFF;
      ys[n] = (data >> 14) & 0x3FFF;
      ps[n] = static_cast<int16_t>((data >> 28) & 0xF);
      ts[n] = t32;
      n++;
    }
    return n;
  }

  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Streaming event filters (host-side, per packet)
// ---------------------------------------------------------------------------

// Activity-noise filter state: per-pixel last-event timestamp map.
// Replaces Metavision's ActivityNoiseFilterAlgorithm
// (reference: depth_reprojection_pipe.py:4,65-67,117): an event survives if
// any pixel in its 3x3 neighborhood fired within the time window before it.
struct ActivityFilter {
  int32_t width = 0;
  int32_t height = 0;
  int64_t window_us = 0;
  int64_t* last_ts = nullptr;  // (height+2) x (width+2), 1-px border

  ~ActivityFilter() { free(last_ts); }
};

extern "C" {

void* act_filter_create(int32_t width, int32_t height, int64_t window_us) {
  auto* f = new ActivityFilter();
  f->width = width;
  f->height = height;
  f->window_us = window_us;
  size_t n = static_cast<size_t>(width + 2) * (height + 2);
  f->last_ts = static_cast<int64_t*>(malloc(n * sizeof(int64_t)));
  for (size_t i = 0; i < n; i++) f->last_ts[i] = INT64_MIN / 2;
  return f;
}

void act_filter_destroy(void* h) { delete static_cast<ActivityFilter*>(h); }

void act_filter_reset(void* h) {
  auto* f = static_cast<ActivityFilter*>(h);
  size_t n = static_cast<size_t>(f->width + 2) * (f->height + 2);
  for (size_t i = 0; i < n; i++) f->last_ts[i] = INT64_MIN / 2;
}

// Filters events in place (SoA); returns the surviving count.  Events must
// be time-ordered.  keep_polarity: -1 = keep all, 0/1 = keep only that
// polarity first (fuses the reference's PolarityFilterAlgorithm step,
// depth_reprojection_pipe.py:114).
int64_t act_filter_apply(void* h, int64_t n, uint16_t* xs, uint16_t* ys,
                         int16_t* ps, int64_t* ts, int32_t keep_polarity) {
  auto* f = static_cast<ActivityFilter*>(h);
  const int32_t stride = f->width + 2;
  int64_t m = 0;
  for (int64_t i = 0; i < n; i++) {
    if (keep_polarity >= 0 && ps[i] != keep_polarity) continue;
    const int32_t x = xs[i] + 1;
    const int32_t y = ys[i] + 1;
    const int64_t t = ts[i];
    int64_t* row0 = f->last_ts + static_cast<size_t>(y - 1) * stride + (x - 1);
    int64_t* row1 = row0 + stride;
    int64_t* row2 = row1 + stride;
    int64_t best = row0[0];
    if (row0[1] > best) best = row0[1];
    if (row0[2] > best) best = row0[2];
    if (row1[0] > best) best = row1[0];
    if (row1[2] > best) best = row1[2];
    if (row2[0] > best) best = row2[0];
    if (row2[1] > best) best = row2[1];
    if (row2[2] > best) best = row2[2];
    const bool keep = (t - best) <= f->window_us;
    row1[1] = t;
    if (keep) {
      xs[m] = xs[i];
      ys[m] = ys[i];
      ps[m] = ps[i];
      ts[m] = t;
      m++;
    }
  }
  return m;
}

}  // extern "C"

// mvtrim_host: native host media layer for the motion trimmer.
//
// This is the host half of the framework: everything FFmpeg-adjacent that
// cannot (and should not) run on the device.  It plays the role the reference
// implementation's memory_io.cpp + motion_scanner.cpp (decode half) +
// ffmpeg_executor.cpp play (see /root/reference), but with a library API
// shaped for batched device consumption:
//
//   * mvt_open/mvt_probe/mvt_close — mmap'd ingest + codec probe.  The file
//     is mapped read-only (MAP_POPULATE) and decoded through a custom AVIO
//     over the mapping, so N concurrent scanner handles share page cache.
//   * mvt_scan_grids — decode a time range with motion-vector export and
//     scatter each analyzed frame's MVs into a dense uint8 vote grid
//     (saturating, thresholded, vertically masked) — byte-identical to the
//     reference's phase-1 vote loop (motion_scanner.cpp:242-268).  Output
//     is [n_frames, gh*gw] ready for H2D transfer.
//   * mvt_scan_mvs — raw MV side-data export (for the fused device kernel
//     and the extract_mvs tool).
//   * mvt_scan_luma — decoded luma planes (for the pixel-domain SAD path
//     when a stream has no usable motion vectors).
//   * mvt_cut — lossless segment concat via libavformat stream copy (the
//     reference shells out to the ffmpeg binary with a concat list;
//     this environment has no binary, so the remux is native).
//   * mvt_synth — synthetic moving-box clip generator for tests/benches
//     (the reference has no tests; SURVEY.md §4 requires us to build them).
//
// Exact-semantics notes are inline at each decision point with
// reference file:line citations.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <chrono>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#ifdef MVT_LIBAV_ABI
// An FFmpeg 8 runtime without its development files (see libav_abi.h).
#include "libav_abi.h"
#else
extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/motion_vector.h>
#include <libavutil/opt.h>
}
#endif

#define MVT_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

using Clock = std::chrono::steady_clock;

long long us_since(Clock::time_point t0) {
  return std::chrono::duration_cast<std::chrono::microseconds>(Clock::now() -
                                                               t0)
      .count();
}

void set_err(char *err, int errlen, const std::string &msg) {
  if (err && errlen > 0) {
    std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
  }
}

// ---------------------------------------------------------------------------
// mmap'd input + custom AVIO
// ---------------------------------------------------------------------------

struct MappedFile {
  const uint8_t *data = nullptr;
  size_t size = 0;

  bool open(const char *path) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st{};
    if (fstat(fd, &st) != 0 || st.st_size <= 0) {
      ::close(fd);
      return false;
    }
    size = static_cast<size_t>(st.st_size);
    void *p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE | MAP_POPULATE, fd, 0);
    ::close(fd);
    if (p == MAP_FAILED) return false;
    // Sequential decode access pattern; huge pages help the demuxer walk.
    madvise(p, size, MADV_SEQUENTIAL);
#ifdef MADV_HUGEPAGE
    madvise(p, size, MADV_HUGEPAGE);
#endif
    data = static_cast<const uint8_t *>(p);
    return true;
  }

  void close() {
    if (data) munmap(const_cast<uint8_t *>(data), size);
    data = nullptr;
    size = 0;
  }
};

struct MemReader {
  const uint8_t *data;
  size_t size;
  size_t pos;
};

int mem_read(void *opaque, uint8_t *buf, int buf_size) {
  auto *st = static_cast<MemReader *>(opaque);
  if (st->pos >= st->size) return AVERROR_EOF;
  size_t n = std::min(static_cast<size_t>(buf_size), st->size - st->pos);
  std::memcpy(buf, st->data + st->pos, n);
  st->pos += n;
  return static_cast<int>(n);
}

int64_t mem_seek(void *opaque, int64_t offset, int whence) {
  auto *st = static_cast<MemReader *>(opaque);
  switch (whence & ~AVSEEK_FORCE) {
    case AVSEEK_SIZE:
      return static_cast<int64_t>(st->size);
    case SEEK_SET:
      break;
    case SEEK_CUR:
      offset += static_cast<int64_t>(st->pos);
      break;
    case SEEK_END:
      offset += static_cast<int64_t>(st->size);
      break;
    default:
      return AVERROR(EINVAL);
  }
  if (offset < 0 || offset > static_cast<int64_t>(st->size))
    return AVERROR(EINVAL);
  st->pos = static_cast<size_t>(offset);
  return offset;
}

constexpr int kAvioBufferSize = 256 * 1024;  // demux read granularity

// ---------------------------------------------------------------------------
// Decoder handle
// ---------------------------------------------------------------------------

// Open modes: MV export skips IDCT/loop-filter/B-frames (reference decoder
// knobs, motion_scanner.cpp:148-169); LUMA decodes real pixels (gray);
// MV_FULL exports MVs with default decode (every frame incl. B — the
// extract_mvs tool contract, tools/extract_mvs.cpp:84-91).
enum MvtMode : int { MVT_MODE_MV = 0, MVT_MODE_LUMA = 1, MVT_MODE_MV_FULL = 2 };

struct MvtHandle {
  MappedFile file;
  MemReader reader{};
  AVFormatContext *fmt = nullptr;
  AVIOContext *avio = nullptr;
  AVCodecContext *dec = nullptr;
  AVFrame *frame = nullptr;
  AVPacket *pkt = nullptr;
  int video_idx = -1;
  double time_base = 0.0;
  int mode = MVT_MODE_MV;
  bool scanned = false;  // has any scan_loop consumed from this handle?
  // Frame-skip modulo phase of the handle's decode position: the number
  // of frames the decoder has produced since the range's seek.  Carried
  // across capped scan_* calls in resume mode so a resumed sub-range
  // continues the chunk's phase exactly like the reference's single
  // counter per chunk scan (motion_scanner.cpp:314,356-357).
  int skip_phase = 0;

  ~MvtHandle() {
    if (dec) avcodec_free_context(&dec);
    if (fmt) avformat_close_input(&fmt);
    // With AVFMT_FLAG_CUSTOM_IO, avformat_close_input does NOT free the
    // AVIO context or its buffer — the caller owns both.  The buffer is
    // read from the context (FFmpeg may have reallocated it internally).
    if (avio) {
      av_freep(&avio->buffer);
      avio_context_free(&avio);
    }
    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    file.close();
  }
};

}  // namespace

MVT_EXPORT MvtHandle *mvt_open(const char *path, int mode, char *err,
                               int errlen) {
  av_log_set_level(AV_LOG_ERROR);
  auto *h = new MvtHandle();
  h->mode = mode;

  if (!h->file.open(path)) {
    set_err(err, errlen, std::string("mmap failed: ") + path);
    delete h;
    return nullptr;
  }

  h->fmt = avformat_alloc_context();
  uint8_t *avio_buf = static_cast<uint8_t *>(av_malloc(kAvioBufferSize));
  h->reader = {h->file.data, h->file.size, 0};
  h->avio = avio_alloc_context(avio_buf, kAvioBufferSize, 0, &h->reader,
                               mem_read, nullptr, mem_seek);
  if (!h->fmt || !h->avio) {
    if (!h->avio) av_free(avio_buf);  // context never took ownership
    set_err(err, errlen, "alloc failed");
    delete h;
    return nullptr;
  }
  h->fmt->pb = h->avio;
  h->fmt->flags |= AVFMT_FLAG_CUSTOM_IO;

  if (avformat_open_input(&h->fmt, "RAM", nullptr, nullptr) < 0) {
    set_err(err, errlen, "avformat_open_input failed");
    delete h;
    return nullptr;
  }
  if (avformat_find_stream_info(h->fmt, nullptr) < 0) {
    set_err(err, errlen, "avformat_find_stream_info failed");
    delete h;
    return nullptr;
  }
  h->video_idx =
      av_find_best_stream(h->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
  if (h->video_idx < 0) {
    set_err(err, errlen, "no video stream");
    delete h;
    return nullptr;
  }
  for (unsigned i = 0; i < h->fmt->nb_streams; i++) {
    if (static_cast<int>(i) != h->video_idx)
      h->fmt->streams[i]->discard = AVDISCARD_ALL;
  }

  AVCodecParameters *par = h->fmt->streams[h->video_idx]->codecpar;
  const AVCodec *codec = avcodec_find_decoder(par->codec_id);
  if (!codec) {
    set_err(err, errlen, "no decoder for codec");
    delete h;
    return nullptr;
  }
  h->dec = avcodec_alloc_context3(codec);
  avcodec_parameters_to_context(h->dec, par);

  if (mode == MVT_MODE_MV) {
    // Decode as little as possible: MVs live in the bitstream syntax, not
    // the pixels (same knob set as the reference, motion_scanner.cpp:148-162).
    h->dec->skip_loop_filter = AVDISCARD_ALL;
    h->dec->skip_idct = AVDISCARD_ALL;
    h->dec->skip_frame = AVDISCARD_BIDIR;
    h->dec->flags2 |= AV_CODEC_FLAG2_FAST;
    h->dec->flags |= AV_CODEC_FLAG_GRAY;
  } else if (mode == MVT_MODE_LUMA) {
    // Luma path needs real pixels; still skip B-frames and chroma.
    h->dec->skip_frame = AVDISCARD_BIDIR;
    h->dec->flags |= AV_CODEC_FLAG_GRAY;
    h->dec->flags2 |= AV_CODEC_FLAG2_FAST;
  }
  // MVT_MODE_MV_FULL: default decode, every frame (extract_mvs contract).
  h->dec->thread_count = 1;  // parallelism lives at the chunk level
  // Slice threading keeps the (single-threaded) decoder on the cheap
  // slice path instead of frame-threading setup (motion_scanner.cpp:161-162).
  h->dec->thread_type = FF_THREAD_SLICE;

  AVDictionary *opts = nullptr;
  if (mode == MVT_MODE_MV || mode == MVT_MODE_MV_FULL) {
    av_dict_set(&opts, "flags2", "+export_mvs", 0);
  }
  int ret = avcodec_open2(h->dec, codec, &opts);
  av_dict_free(&opts);
  if (ret < 0) {
    set_err(err, errlen, "avcodec_open2 failed");
    delete h;
    return nullptr;
  }

  h->frame = av_frame_alloc();
  h->pkt = av_packet_alloc();
  h->time_base = av_q2d(h->fmt->streams[h->video_idx]->time_base);
  return h;
}

MVT_EXPORT void mvt_close(MvtHandle *h) { delete h; }

MVT_EXPORT int mvt_probe(MvtHandle *h, double *duration, double *fps,
                         int *width, int *height) {
  if (!h) return -1;
  // duration: container duration / AV_TIME_BASE (motion_scanner.cpp:204-208)
  *duration = (h->fmt->duration != AV_NOPTS_VALUE)
                  ? h->fmt->duration / static_cast<double>(AV_TIME_BASE)
                  : 0.0;
  // fps: avg_frame_rate with 25.0 fallback (motion_scanner.cpp:210-215)
  AVRational r = h->fmt->streams[h->video_idx]->avg_frame_rate;
  *fps = (r.den > 0) ? av_q2d(r) : 25.0;
  *width = h->dec->width;
  *height = h->dec->height;
  return 0;
}

namespace {

// Shared scan-loop driver.  Seeks (if start > 0), decodes, applies the
// frame-skip phase and PTS window exactly like the reference scan_range
// (motion_scanner.cpp:297-391): the skip counter pre-increments on every
// *decoded* frame (including ones before the window), the window test is
// [start, end) on pts*time_base, and the scan stops at the first analyzed
// frame at/after `end`.
//
// `resume != 0` continues a capped scan: no seek/flush (decode proceeds
// from the handle's current stream position), the skip counter resumes
// from h->skip_phase, and frames the decoder buffered when the previous
// call stopped are drained first.  A chunk scanned as one call and a
// chunk scanned as a capped call plus resumes analyze the IDENTICAL
// frame set — the reference (which has no frame cap) scans each chunk
// with one uninterrupted counter (motion_scanner.cpp:314,356-357), and
// resume mode reproduces that across the cap boundary.
template <typename EmitFn>
long scan_loop(MvtHandle *h, double start, double end, int frame_skip,
               long max_frames, long long *timing_us, EmitFn &&emit,
               int resume = 0) {
  if (!h) return -1;
  if (frame_skip < 1) frame_skip = 1;
  if (max_frames <= 0) return 0;
  long long seek_us = 0, decode_us = 0, analyze_us = 0;
  long n_emitted = 0;

  // The reference only seeks when start > 0 (motion_scanner.cpp:321-325)
  // because each of its scanners is used once from byte 0.  Our handles are
  // reusable across ranges, so we rewind on reuse; a fresh handle asked for
  // start=0 is already positioned at byte 0 and skips the seek+flush like
  // the reference does (a BACKWARD seek to ts 0 would land on the same
  // first keyframe, but the flush costs decoder re-priming time).
  auto t0 = Clock::now();
  if (!resume) {
    if (h->scanned || start > 0) {
      int64_t seek_ts = static_cast<int64_t>(start / h->time_base);
      av_seek_frame(h->fmt, h->video_idx, seek_ts, AVSEEK_FLAG_BACKWARD);
      avcodec_flush_buffers(h->dec);
    }
    h->skip_phase = 0;
  }
  h->scanned = true;
  seek_us = us_since(t0);

  int frame_count = h->skip_phase;
  bool done = false;

  // Receive every frame the decoder currently holds.  Used both for the
  // resume pre-drain (frames buffered when a capped call stopped
  // mid-packet) and after each sent packet.
  auto drain = [&]() {
    while (!done) {
      auto td = Clock::now();
      int recv_ret = avcodec_receive_frame(h->dec, h->frame);
      decode_us += us_since(td);
      if (recv_ret < 0) break;

      // frame-skip phase: counter advances on every decoded frame and
      // spans cap-resumes (motion_scanner.cpp:356-357)
      if (++frame_count % frame_skip != 0) continue;

      double pts = h->frame->pts * h->time_base;
      if (pts < start) continue;
      if (pts >= end) {
        done = true;
        break;
      }

      auto ta = Clock::now();
      emit(h->frame, pts, n_emitted);
      analyze_us += us_since(ta);
      n_emitted++;
      if (n_emitted >= max_frames) {
        // Buffer full: stop AFTER emitting, so a resume continues with
        // the next decoded frame — nothing is dropped or re-decoded
        // across the cap boundary.
        done = true;
        break;
      }
    }
  };

  if (resume) drain();
  while (!done && av_read_frame(h->fmt, h->pkt) >= 0) {
    if (h->pkt->stream_index == h->video_idx) {
      auto td = Clock::now();
      int send_ret = avcodec_send_packet(h->dec, h->pkt);
      decode_us += us_since(td);
      if (send_ret >= 0) drain();
    }
    av_packet_unref(h->pkt);
  }

  h->skip_phase = frame_count;
  if (timing_us) {
    timing_us[0] += seek_us;
    timing_us[1] += decode_us;
    timing_us[2] += analyze_us;
  }
  return n_emitted;
}

// Single-threshold MV vote loop shared by the grids/bits/words scatters.
// Byte-identical to the reference phase-1 loop (motion_scanner.cpp:
// 242-268): integer (dst-src)^2 magnitude vs double threshold (strict <,
// skip), arithmetic-shift grid mapping, x in [0,gw), y in [y_min,y_max),
// saturating uint8 increment.
inline void vote_scatter(const AVMotionVector *mvs, int count,
                         double threshold_sq, int block_shift, int gw,
                         int y_min, int y_max, uint8_t *grid) {
  for (int i = 0; i < count; ++i) {
    const AVMotionVector *mv = &mvs[i];
    int dx = mv->dst_x - mv->src_x;
    int dy = mv->dst_y - mv->src_y;
    int mag_sq = dx * dx + dy * dy;
    if (mag_sq < threshold_sq) continue;
    int gx = mv->dst_x >> block_shift;
    int gy = mv->dst_y >> block_shift;
    if (gx >= 0 && gx < gw && gy >= y_min && gy < y_max) {
      uint8_t &cell = grid[static_cast<size_t>(gy) * gw + gx];
      if (cell < 255) cell++;
    }
  }
}

// Threshold the vote grid and pack the activity mask little-endian along
// x, `row_bytes` output bytes per row (gwb for mvt_scan_bits, gww*4 for
// mvt_scan_words — byte j of a row is bit-identical between the two for
// j < gwb, zero beyond; `bits` must be pre-zeroed).
inline void pack_mask_rows(const uint8_t *grid, int gw, int gh,
                           int vectors_needed, uint8_t *bits,
                           int row_bytes) {
  for (int y = 0; y < gh; ++y) {
    const uint8_t *row = grid + static_cast<size_t>(y) * gw;
    uint8_t *brow = bits + static_cast<size_t>(y) * row_bytes;
    for (int x = 0; x < gw; ++x) {
      if (row[x] >= vectors_needed)
        brow[x >> 3] |= static_cast<uint8_t>(1u << (x & 7));
    }
  }
}

// Shared emit body of the packed activity-mask scatters (mvt_scan_bits /
// mvt_scan_words); the only degree of freedom is the output row stride.
// Frames without MV side data emit all-zero masks: the reference's
// check_frame returns false before phase 2 ever runs (`if (!sd) return
// false`, motion_scanner.cpp:219-221), so even under VECTORS_NEEDED=0 —
// where zero-vote cells of a frame WITH side data satisfy >= 0 and
// pack_mask_rows sets every valid bit — an MV-less frame must stay
// all-zero, never "degenerately active".
inline void emit_packed_mask(AVFrame *f, double pts, long slot,
                             uint8_t *out, size_t bytes_per_frame,
                             int row_bytes, double threshold_sq,
                             int block_shift, int gw, int gh, int y_min,
                             int y_max, int vectors_needed,
                             std::vector<uint8_t> &grid, double *out_pts,
                             long long *timing_us) {
  uint8_t *bits = out + static_cast<size_t>(slot) * bytes_per_frame;
  std::memset(bits, 0, bytes_per_frame);
  out_pts[slot] = pts;

  AVFrameSideData *sd =
      av_frame_get_side_data(f, AV_FRAME_DATA_MOTION_VECTORS);
  if (sd) {
    if (timing_us) timing_us[3]++;  // frames that carried MV side data
    std::memset(grid.data(), 0, grid.size());
    vote_scatter(reinterpret_cast<const AVMotionVector *>(sd->data),
                 static_cast<int>(sd->size / sizeof(AVMotionVector)),
                 threshold_sq, block_shift, gw, y_min, y_max, grid.data());
    pack_mask_rows(grid.data(), gw, gh, vectors_needed, bits, row_bytes);
  }
}

}  // namespace

// Scatter MV side data into a dense uint8 vote grid (the shared
// vote_scatter loop above — byte-identical to the reference phase-1
// loop, motion_scanner.cpp:242-268).
// Frames without MV side data (I-frames) emit all-zero grids, which the
// device cluster kernel maps to "no motion" — same decision as the
// reference's early `return false` (motion_scanner.cpp:219-221) — for
// every VECTORS_NEEDED >= 1.  At VECTORS_NEEDED == 0 a zero grid is
// ambiguous (a side-data frame whose MVs all got filtered also zeroes,
// yet the reference decides it TRUE at vec_need 0): grid consumers
// cannot be exact there, so the pipeline routes vec_need<=0 decisions
// through mvt_scan_bits, whose masks carry side-data presence.
MVT_EXPORT long mvt_scan_grids(MvtHandle *h, double start, double end,
                               double threshold_sq, int block_shift, int gw,
                               int gh, int y_min, int y_max, int frame_skip,
                               long max_frames, uint8_t *out_grids,
                               double *out_pts, long long *timing_us,
                               int resume) {
  const size_t grid_cells = static_cast<size_t>(gw) * gh;
  return scan_loop(
      h, start, end, frame_skip, max_frames, timing_us,
      [&](AVFrame *f, double pts, long slot) {
        uint8_t *grid = out_grids + static_cast<size_t>(slot) * grid_cells;
        std::memset(grid, 0, grid_cells);
        out_pts[slot] = pts;

        AVFrameSideData *sd =
            av_frame_get_side_data(f, AV_FRAME_DATA_MOTION_VECTORS);
        if (!sd) return;
        if (timing_us) timing_us[3]++;  // frames that carried MV side data
        vote_scatter(reinterpret_cast<const AVMotionVector *>(sd->data),
                     static_cast<int>(sd->size / sizeof(AVMotionVector)),
                     threshold_sq, block_shift, gw, y_min, y_max, grid);
      },
      resume);
}

// Bit-packed activity-mask scatter: same decode + vote loop as
// mvt_scan_grids, but the per-frame output is the *thresholded* activity
// mask (cell >= vectors_needed) packed little-endian along x — bit k of
// byte j covers grid x = j*8+k (numpy unpackbits bitorder='little').
// Exactness: the reference's phase-2 cluster test (motion_scanner.cpp:
// 277-293) reads votes only through `>= VECTORS_NEEDED` comparisons, so
// the boolean mask carries the full decision.  Packing shrinks H2D to
// gh*ceil(gw/8) bytes/frame — 8x less PCIe traffic than the uint8 grids.
MVT_EXPORT long mvt_scan_bits(MvtHandle *h, double start, double end,
                              double threshold_sq, int block_shift, int gw,
                              int gh, int y_min, int y_max,
                              int vectors_needed, int frame_skip,
                              long max_frames, uint8_t *out_bits,
                              double *out_pts, long long *timing_us,
                              int resume) {
  const size_t grid_cells = static_cast<size_t>(gw) * gh;
  const int gwb = (gw + 7) / 8;
  const size_t bits_per_frame = static_cast<size_t>(gwb) * gh;
  std::vector<uint8_t> grid(grid_cells);
  return scan_loop(
      h, start, end, frame_skip, max_frames, timing_us,
      [&](AVFrame *f, double pts, long slot) {
        emit_packed_mask(f, pts, slot, out_bits, bits_per_frame, gwb,
                         threshold_sq, block_shift, gw, gh, y_min, y_max,
                         vectors_needed, grid, out_pts, timing_us);
      },
      resume);
}

// Word-layout activity-mask scatter: the same thresholded mask as
// mvt_scan_bits, but rows are padded to 4-byte multiples so the output is
// directly the int32 word layout the device cluster kernel consumes
// (ops/cluster.word_geometry: word w of a row holds cells x = 32w..32w+31,
// little-endian — byte j of the row is bit-identical to mvt_scan_bits'
// byte j for j < ceil(gw/8), zero beyond).  Emitting this natively moves
// the per-frame repack (ops/cluster.repack_bits_words) off the Python
// feeder and into the GIL-released decode workers, so the feeder only
// assembles batches — the scale-out contract for many-core hosts
// (reference analog: fully independent workers, batch_processor.cpp:
// 153-157).  out_words is int32 [max_frames, gh*gww]; the host is
// little-endian, so byte writes produce the '<i4' view exactly.
MVT_EXPORT long mvt_scan_words(MvtHandle *h, double start, double end,
                               double threshold_sq, int block_shift, int gw,
                               int gh, int y_min, int y_max,
                               int vectors_needed, int frame_skip,
                               long max_frames, int32_t *out_words,
                               double *out_pts, long long *timing_us,
                               int resume) {
  const size_t grid_cells = static_cast<size_t>(gw) * gh;
  const int gww = (gw + 31) / 32;
  const int row_bytes = gww * 4;
  const size_t bytes_per_frame = static_cast<size_t>(row_bytes) * gh;
  std::vector<uint8_t> grid(grid_cells);
  return scan_loop(
      h, start, end, frame_skip, max_frames, timing_us,
      [&](AVFrame *f, double pts, long slot) {
        emit_packed_mask(f, pts, slot,
                         reinterpret_cast<uint8_t *>(out_words),
                         bytes_per_frame, row_bytes, threshold_sq,
                         block_shift, gw, gh, y_min, y_max,
                         vectors_needed, grid, out_pts, timing_us);
      },
      resume);
}

// Multi-threshold vote scatter: one decode pass produces K vote grids per
// frame, one per MV_THRESHOLD_SQ candidate (each byte-exact to the
// reference phase-1 loop at that threshold).  The config-sweep tool rides
// this: K thresholds cost one decode and K*gh*gw bytes per frame instead
// of the raw-MV export's max_mv*8.
MVT_EXPORT long mvt_scan_grids_multi(
    MvtHandle *h, double start, double end, const double *thresholds_sq,
    int n_thresholds, int block_shift, int gw, int gh, int y_min, int y_max,
    int frame_skip, long max_frames, uint8_t *out_grids /* [mf,K,gh*gw] */,
    double *out_pts, uint8_t *out_has_mv /* [mf], nullable */,
    long long *timing_us, int resume) {
  const size_t grid_cells = static_cast<size_t>(gw) * gh;
  const size_t per_frame = grid_cells * static_cast<size_t>(n_thresholds);
  return scan_loop(
      h, start, end, frame_skip, max_frames, timing_us,
      [&](AVFrame *f, double pts, long slot) {
        uint8_t *grids = out_grids + static_cast<size_t>(slot) * per_frame;
        std::memset(grids, 0, per_frame);
        out_pts[slot] = pts;

        AVFrameSideData *sd =
            av_frame_get_side_data(f, AV_FRAME_DATA_MOTION_VECTORS);
        // A zero vote grid cannot distinguish "no MV side data" (the
        // reference's unconditional `!sd -> false`,
        // motion_scanner.cpp:219-221) from "MVs present but none voted";
        // the flag carries that bit so vec_needed<=0 sweeps stay exact.
        if (out_has_mv) out_has_mv[slot] = sd ? 1 : 0;
        if (!sd) return;
        if (timing_us) timing_us[3]++;
        const auto *mvs = reinterpret_cast<const AVMotionVector *>(sd->data);
        const int count = static_cast<int>(sd->size / sizeof(AVMotionVector));
        for (int i = 0; i < count; ++i) {
          const AVMotionVector *mv = &mvs[i];
          int dx = mv->dst_x - mv->src_x;
          int dy = mv->dst_y - mv->src_y;
          int mag_sq = dx * dx + dy * dy;
          int gx = mv->dst_x >> block_shift;
          int gy = mv->dst_y >> block_shift;
          if (gx >= 0 && gx < gw && gy >= y_min && gy < y_max) {
            const size_t idx = static_cast<size_t>(gy) * gw + gx;
            for (int k = 0; k < n_thresholds; ++k) {
              if (mag_sq < thresholds_sq[k]) continue;
              uint8_t &cell = grids[static_cast<size_t>(k) * grid_cells + idx];
              if (cell < 255) cell++;
            }
          }
        }
      },
      resume);
}

// Raw MV export: int16 rows (dst_x, dst_y, src_x, src_y) padded to max_mv
// per frame, plus per-frame counts.  Overflowing frames are truncated and
// reported via a negative count (-real_count).
MVT_EXPORT long mvt_scan_mvs(MvtHandle *h, double start, double end,
                             int frame_skip, long max_frames, long max_mv,
                             int16_t *out_mvs, int32_t *out_counts,
                             double *out_pts, long long *timing_us,
                             int resume) {
  return scan_loop(
      h, start, end, frame_skip, max_frames, timing_us,
      [&](AVFrame *f, double pts, long slot) {
        out_pts[slot] = pts;
        int16_t *dstp = out_mvs + static_cast<size_t>(slot) * max_mv * 4;
        AVFrameSideData *sd =
            av_frame_get_side_data(f, AV_FRAME_DATA_MOTION_VECTORS);
        if (!sd) {
          out_counts[slot] = 0;
          return;
        }
        if (timing_us) timing_us[3]++;  // frames that carried MV side data
        const auto *mvs = reinterpret_cast<const AVMotionVector *>(sd->data);
        const long count =
            static_cast<long>(sd->size / sizeof(AVMotionVector));
        const long n = std::min(count, max_mv);
        for (long i = 0; i < n; ++i) {
          dstp[i * 4 + 0] = mvs[i].dst_x;
          dstp[i * 4 + 1] = mvs[i].dst_y;
          dstp[i * 4 + 2] = mvs[i].src_x;
          dstp[i * 4 + 3] = mvs[i].src_y;
        }
        out_counts[slot] =
            (count > max_mv) ? -static_cast<int32_t>(count)
                             : static_cast<int32_t>(count);
      },
      resume);
}

// Full-field MV export for the extract_mvs tool (tools/extract_mvs.cpp
// JSON schema): 10 int32 fields per MV — dst_x, dst_y, src_x, src_y, w, h,
// motion_x, motion_y, motion_scale, source — plus per-frame
// best_effort_timestamp pts and picture type (1=I, 2=P, 3=B, 0=?).
MVT_EXPORT long mvt_scan_mvs_full(MvtHandle *h, double start, double end,
                                  int frame_skip, long max_frames,
                                  long max_mv, int32_t *out_mvs,
                                  int32_t *out_counts, double *out_pts,
                                  int32_t *out_ptype,
                                  long long *timing_us, int resume) {
  const double tb = h ? h->time_base : 0.0;
  return scan_loop(
      h, start, end, frame_skip, max_frames, timing_us,
      [&](AVFrame *f, double /*pts*/, long slot) {
        int64_t bet = f->best_effort_timestamp;
        out_pts[slot] = (bet == AV_NOPTS_VALUE) ? -1.0 : bet * tb;
        out_ptype[slot] = static_cast<int32_t>(f->pict_type);
        int32_t *dst = out_mvs + static_cast<size_t>(slot) * max_mv * 10;
        AVFrameSideData *sd =
            av_frame_get_side_data(f, AV_FRAME_DATA_MOTION_VECTORS);
        if (!sd) {
          out_counts[slot] = 0;
          return;
        }
        const auto *mvs = reinterpret_cast<const AVMotionVector *>(sd->data);
        const long count =
            static_cast<long>(sd->size / sizeof(AVMotionVector));
        const long n = std::min(count, max_mv);
        for (long i = 0; i < n; ++i) {
          const AVMotionVector &mv = mvs[i];
          dst[i * 10 + 0] = mv.dst_x;
          dst[i * 10 + 1] = mv.dst_y;
          dst[i * 10 + 2] = mv.src_x;
          dst[i * 10 + 3] = mv.src_y;
          dst[i * 10 + 4] = mv.w;
          dst[i * 10 + 5] = mv.h;
          dst[i * 10 + 6] = mv.motion_x;
          dst[i * 10 + 7] = mv.motion_y;
          dst[i * 10 + 8] = mv.motion_scale;
          dst[i * 10 + 9] = static_cast<int32_t>(mv.source);
        }
        out_counts[slot] =
            (count > max_mv) ? -static_cast<int32_t>(count)
                             : static_cast<int32_t>(count);
      },
      resume);
}

// Single-pass streaming JSON export of all MV side data — the exact
// extract_mvs tool contract (tools/extract_mvs.cpp:97-176): EVERY decoded
// frame in decode order (incl. B-frames), 1-based frame_index, best-effort
// pts (null when unknown), frame type, and per-MV integer dst plus sub-pel
// src derived from motion_x/motion_scale.  O(1) memory; no pts windowing,
// so B-frames landing across arbitrary time boundaries cannot be dropped.
MVT_EXPORT long mvt_export_mvs_json(const char *video_path,
                                    const char *json_path, char *err,
                                    int errlen) {
  MvtHandle *h = mvt_open(video_path, MVT_MODE_MV_FULL, err, errlen);
  if (!h) return -1;
  FILE *out = fopen(json_path, "w");
  if (!out) {
    set_err(err, errlen, std::string("cannot open ") + json_path);
    mvt_close(h);
    return -1;
  }

  AVRational tbq = h->fmt->streams[h->video_idx]->time_base;
  fprintf(out, "{\n  \"input\": \"%s\",\n  \"time_base\": \"%d/%d\",\n"
               "  \"frames\": [\n",
          video_path, tbq.num, tbq.den);

  long frame_index = 0;
  bool first_frame = true;
  auto emit_frame = [&](AVFrame *f) {
    frame_index++;
    int64_t bet = f->best_effort_timestamp;
    AVFrameSideData *sd =
        av_frame_get_side_data(f, AV_FRAME_DATA_MOTION_VECTORS);
    const auto *mvs =
        sd ? reinterpret_cast<const AVMotionVector *>(sd->data) : nullptr;
    const long count =
        sd ? static_cast<long>(sd->size / sizeof(AVMotionVector)) : 0;
    const char *ftype = (f->pict_type == AV_PICTURE_TYPE_I)   ? "I"
                        : (f->pict_type == AV_PICTURE_TYPE_P) ? "P"
                        : (f->pict_type == AV_PICTURE_TYPE_B) ? "B"
                                                              : "?";
    if (!first_frame) fprintf(out, ",\n");
    first_frame = false;
    fprintf(out, "    {\n      \"frame_index\": %ld,\n", frame_index);
    if (bet != AV_NOPTS_VALUE)
      fprintf(out, "      \"pts_seconds\": %.6f,\n", bet * h->time_base);
    else
      fprintf(out, "      \"pts_seconds\": null,\n");
    fprintf(out, "      \"frame_type\": \"%s\",\n", ftype);
    fprintf(out, "      \"num_mvs\": %ld,\n", count);
    fprintf(out, "      \"motion_vectors\": [");
    for (long i = 0; i < count; ++i) {
      const AVMotionVector &mv = mvs[i];
      const int scale = mv.motion_scale ? mv.motion_scale : 1;
      if (i) fprintf(out, ",");
      fprintf(out,
              "\n        {\"dst_x\":%d,\"dst_y\":%d,"
              "\"src_x\":%.3f,\"src_y\":%.3f,\"w\":%d,\"h\":%d,"
              "\"motion_x\":%d,\"motion_y\":%d,\"motion_scale\":%d,"
              "\"source\":%d}",
              mv.dst_x, mv.dst_y,
              mv.dst_x + static_cast<double>(mv.motion_x) / scale,
              mv.dst_y + static_cast<double>(mv.motion_y) / scale,
              mv.w, mv.h, mv.motion_x, mv.motion_y, mv.motion_scale,
              static_cast<int>(mv.source));
    }
    if (count) fprintf(out, "\n      ");
    fprintf(out, "]\n    }");
  };

  while (av_read_frame(h->fmt, h->pkt) >= 0) {
    if (h->pkt->stream_index == h->video_idx &&
        avcodec_send_packet(h->dec, h->pkt) >= 0) {
      while (avcodec_receive_frame(h->dec, h->frame) == 0) {
        emit_frame(h->frame);
      }
    }
    av_packet_unref(h->pkt);
  }
  // drain the decoder (B-frame reordering holds frames back)
  if (avcodec_send_packet(h->dec, nullptr) >= 0) {
    while (avcodec_receive_frame(h->dec, h->frame) == 0) {
      emit_frame(h->frame);
    }
  }

  fprintf(out, "\n  ]\n}\n");
  fclose(out);
  mvt_close(h);
  return frame_index;
}

// Stream inventory (n_streams, n_audio) — lets tests assert the cut
// carried non-video streams through.
MVT_EXPORT int mvt_stream_counts(MvtHandle *h, int *n_streams,
                                 int *n_audio) {
  if (!h) return -1;
  *n_streams = static_cast<int>(h->fmt->nb_streams);
  int audio = 0;
  for (unsigned i = 0; i < h->fmt->nb_streams; i++) {
    if (h->fmt->streams[i]->codecpar->codec_type == AVMEDIA_TYPE_AUDIO)
      audio++;
  }
  *n_audio = audio;
  return 0;
}

// Stream time base (for the extract_mvs JSON header).
MVT_EXPORT int mvt_time_base(MvtHandle *h, int *num, int *den) {
  if (!h || h->video_idx < 0) return -1;
  AVRational tb = h->fmt->streams[h->video_idx]->time_base;
  *num = tb.num;
  *den = tb.den;
  return 0;
}

// Decoded luma planes for the pixel-domain SAD fallback.  Emits the full
// luma plane (stride removed) per analyzed frame.
MVT_EXPORT long mvt_scan_luma(MvtHandle *h, double start, double end,
                              int frame_skip, long max_frames,
                              uint8_t *out_luma, double *out_pts,
                              long long *timing_us, int resume) {
  const int w = h ? h->dec->width : 0;
  const int ht = h ? h->dec->height : 0;
  return scan_loop(
      h, start, end, frame_skip, max_frames, timing_us,
      [&](AVFrame *f, double pts, long slot) {
        out_pts[slot] = pts;
        uint8_t *dst =
            out_luma + static_cast<size_t>(slot) * w * ht;
        if (!f->data[0]) {
          std::memset(dst, 0, static_cast<size_t>(w) * ht);
          return;
        }
        for (int y = 0; y < ht; ++y) {
          std::memcpy(dst + static_cast<size_t>(y) * w,
                      f->data[0] + static_cast<size_t>(y) * f->linesize[0],
                      static_cast<size_t>(w));
        }
      },
      resume);
}

// ---------------------------------------------------------------------------
// Lossless cut: native segment concat via stream copy
// ---------------------------------------------------------------------------

// Equivalent of the reference's `ffmpeg -f concat -c copy` invocation
// (pipeline.cpp:517-523) without the external binary: for each kept
// segment, seek the video stream to the keyframe at/before inpoint, stream
// -copy packets until the first video packet at/after outpoint, and splice
// segments onto a monotonic output timeline.  Like concat+copy, video cuts
// land on keyframe boundaries; `+faststart`-style header relocation is the
// mp4 muxer's `faststart` movflag.
// segments: [in0, out0, in1, out1, ...] seconds, already %.2f-quantized by
// the caller (the pipeline formats cut points exactly like the reference's
// concat list, pipeline.cpp:468-469).
MVT_EXPORT int mvt_cut(const char *input, const char *output,
                       const double *segments, int nseg, char *err,
                       int errlen) {
  av_log_set_level(AV_LOG_ERROR);
  AVFormatContext *in = nullptr;
  AVFormatContext *out = nullptr;
  int ret = 0;
  std::vector<int> stream_map;
  std::vector<int64_t> next_dts;  // per-output-stream monotonic guard

  if ((ret = avformat_open_input(&in, input, nullptr, nullptr)) < 0) {
    set_err(err, errlen, "open input failed");
    return -1;
  }
  if ((ret = avformat_find_stream_info(in, nullptr)) < 0) {
    avformat_close_input(&in);
    set_err(err, errlen, "find_stream_info failed");
    return -1;
  }
  int video_idx =
      av_find_best_stream(in, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
  if (video_idx < 0) {
    avformat_close_input(&in);
    set_err(err, errlen, "no video stream");
    return -1;
  }

  avformat_alloc_output_context2(&out, nullptr, nullptr, output);
  if (!out) {
    avformat_close_input(&in);
    set_err(err, errlen, "alloc output failed");
    return -1;
  }

  stream_map.assign(in->nb_streams, -1);
  int n_out = 0;
  for (unsigned i = 0; i < in->nb_streams; i++) {
    AVCodecParameters *par = in->streams[i]->codecpar;
    if (par->codec_type != AVMEDIA_TYPE_VIDEO &&
        par->codec_type != AVMEDIA_TYPE_AUDIO &&
        par->codec_type != AVMEDIA_TYPE_SUBTITLE)
      continue;
    AVStream *os = avformat_new_stream(out, nullptr);
    if (!os) continue;
    avcodec_parameters_copy(os->codecpar, par);
    os->codecpar->codec_tag = 0;
    os->time_base = in->streams[i]->time_base;
    stream_map[i] = n_out++;
  }
  next_dts.assign(n_out, AV_NOPTS_VALUE);

  AVDictionary *muxopts = nullptr;
  av_dict_set(&muxopts, "movflags", "+faststart", 0);
  if (!(out->oformat->flags & AVFMT_NOFILE)) {
    if ((ret = avio_open(&out->pb, output, AVIO_FLAG_WRITE)) < 0) {
      set_err(err, errlen, "cannot open output file");
      avformat_close_input(&in);
      avformat_free_context(out);
      av_dict_free(&muxopts);
      return -1;
    }
  }
  if ((ret = avformat_write_header(out, &muxopts)) < 0) {
    set_err(err, errlen, "write_header failed");
    avformat_close_input(&in);
    if (out->pb) avio_closep(&out->pb);
    avformat_free_context(out);
    av_dict_free(&muxopts);
    return -1;
  }
  av_dict_free(&muxopts);

  AVPacket *pkt = av_packet_alloc();
  const AVRational vtb = in->streams[video_idx]->time_base;
  double out_timeline = 0.0;  // seconds of output already emitted
  int rc = 0;

  for (int s = 0; s < nseg && rc == 0; s++) {
    const double seg_in = segments[2 * s];
    const double seg_out = segments[2 * s + 1];
    if (seg_out <= seg_in) continue;

    int64_t seek_ts = static_cast<int64_t>(seg_in / av_q2d(vtb));
    if (av_seek_frame(in, video_idx, seek_ts, AVSEEK_FLAG_BACKWARD) < 0) {
      rc = -1;
      set_err(err, errlen, "seek failed");
      break;
    }

    // The splice anchors the segment's first video packet (the keyframe
    // at/before inpoint) at out_timeline and shifts ALL packets uniformly
    // from there, preserving relative timing within the preroll — like
    // ffmpeg concat+copy, the output segment is keyframe-aligned and may
    // be slightly longer than outpoint-inpoint.
    double seg_base = NAN;  // input time of the segment's first video pkt
    bool segment_done = false;

    while (!segment_done && av_read_frame(in, pkt) >= 0) {
      const unsigned idx = static_cast<unsigned>(pkt->stream_index);
      if (idx >= stream_map.size() || stream_map[idx] < 0) {
        av_packet_unref(pkt);
        continue;
      }
      AVStream *ist = in->streams[idx];
      const double tb = av_q2d(ist->time_base);
      const double pts_sec =
          (pkt->pts == AV_NOPTS_VALUE) ? 0.0 : pkt->pts * tb;

      if (static_cast<int>(idx) == video_idx) {
        if (pts_sec >= seg_out) {
          av_packet_unref(pkt);
          segment_done = true;
          break;
        }
        if (std::isnan(seg_base)) {
          // Anchor on dts when available (it leads pts with B-frames).
          seg_base = (pkt->dts != AV_NOPTS_VALUE) ? pkt->dts * tb : pts_sec;
          if (seg_base > seg_in) seg_base = seg_in;
        }
      } else {
        // Non-video packets: keep only inside the window; drop any that
        // arrive before the anchor keyframe establishes the shift.
        if (std::isnan(seg_base) || pts_sec < seg_in || pts_sec >= seg_out) {
          av_packet_unref(pkt);
          continue;
        }
      }

      const int oidx = stream_map[idx];
      AVStream *ost = out->streams[oidx];
      const double shift = out_timeline - seg_base;
      auto shift_ts = [&](int64_t ts) -> int64_t {
        if (ts == AV_NOPTS_VALUE) return AV_NOPTS_VALUE;
        return static_cast<int64_t>(
            llround((ts * tb + shift) / av_q2d(ost->time_base)));
      };
      pkt->pts = shift_ts(pkt->pts);
      pkt->dts = shift_ts(pkt->dts);
      // Enforce monotonic dts per stream (genpts-style repair).
      if (pkt->dts != AV_NOPTS_VALUE) {
        if (next_dts[oidx] != AV_NOPTS_VALUE && pkt->dts <= next_dts[oidx])
          pkt->dts = next_dts[oidx] + 1;
        if (pkt->pts != AV_NOPTS_VALUE && pkt->pts < pkt->dts)
          pkt->pts = pkt->dts;
        next_dts[oidx] = pkt->dts;
      }
      pkt->duration = av_rescale_q(pkt->duration, ist->time_base,
                                   ost->time_base);
      pkt->pos = -1;
      pkt->stream_index = oidx;
      if (av_interleaved_write_frame(out, pkt) < 0) {
        rc = -1;
        set_err(err, errlen, "write_frame failed");
        break;
      }
    }
    // Advance by the emitted span: keyframe anchor -> outpoint.
    out_timeline += seg_out - (std::isnan(seg_base) ? seg_in : seg_base);
  }

  av_packet_free(&pkt);
  // Finalize can fail on its own (ENOSPC during the mp4 trailer /
  // +faststart moov rewrite, I/O errors on close): a truncated output
  // must never be reported as a successful cut.
  if (av_write_trailer(out) < 0 && rc == 0) {
    rc = -1;
    set_err(err, errlen, "write_trailer failed");
  }
  if (out->pb && avio_closep(&out->pb) < 0 && rc == 0) {
    rc = -1;
    set_err(err, errlen, "output close failed");
  }
  avformat_free_context(out);
  avformat_close_input(&in);
  return rc;
}

// ---------------------------------------------------------------------------
// Synthetic clip generator (tests/benches)
// ---------------------------------------------------------------------------

// Moving-box clip: static textured background everywhere; during each
// [start, end) window in motion_windows a bright box sweeps across the
// frame (guaranteeing large codec MVs).  codec: "libx264" or "mpeg4".
MVT_EXPORT int mvt_synth(const char *path, int w, int h, double fps,
                         double duration_sec, const char *codec_name,
                         const double *motion_windows, int n_windows,
                         int gop, int b_frames, int noise, int with_audio,
                         char *err, int errlen) {
  av_log_set_level(AV_LOG_ERROR);
  AVFormatContext *out = nullptr;
  avformat_alloc_output_context2(&out, nullptr, nullptr, path);
  if (!out) {
    set_err(err, errlen, "alloc output failed");
    return -1;
  }
  const AVCodec *codec = avcodec_find_encoder_by_name(codec_name);
  if (!codec) {
    set_err(err, errlen, std::string("no encoder: ") + codec_name);
    avformat_free_context(out);
    return -1;
  }
  AVStream *st = avformat_new_stream(out, nullptr);
  AVCodecContext *enc = avcodec_alloc_context3(codec);
  enc->width = w;
  enc->height = h;
  enc->pix_fmt = AV_PIX_FMT_YUV420P;
  enc->time_base = av_d2q(1.0 / fps, 100000);
  enc->framerate = av_d2q(fps, 100000);
  enc->gop_size = gop > 0 ? gop : static_cast<int>(fps);
  // 0 keeps every frame a P-frame with MVs (CCTV-like); >0 produces
  // B-frames to exercise the scanner's AVDISCARD_BIDIR skip and the
  // cut's decode-order handling
  enc->max_b_frames = b_frames > 0 ? b_frames : 0;
  enc->bit_rate = static_cast<int64_t>(w) * h * 4;
  if (out->oformat->flags & AVFMT_GLOBALHEADER)
    enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;

  AVDictionary *opts = nullptr;
  if (std::strcmp(codec_name, "libx264") == 0) {
    av_dict_set(&opts, "preset", "fast", 0);
    if (b_frames <= 0) av_dict_set(&opts, "tune", "zerolatency", 0);
    // Sub-16x16 partitions give several MVs per 16px grid cell (real CCTV
    // encoders do too), which the VECTORS_NEEDED>=2 defaults rely on.
    av_dict_set(&opts, "x264-params", "partitions=all", 0);
  } else if (std::strcmp(codec_name, "libx265") == 0) {
    av_dict_set(&opts, "preset", "ultrafast", 0);
    av_dict_set(&opts, "x265-params", "log-level=none", 0);
  }
  if (avcodec_open2(enc, codec, &opts) < 0) {
    set_err(err, errlen, "encoder open failed");
    av_dict_free(&opts);
    avcodec_free_context(&enc);
    avformat_free_context(out);
    return -1;
  }
  av_dict_free(&opts);
  avcodec_parameters_from_context(st->codecpar, enc);
  st->time_base = enc->time_base;

  // Optional mono AAC sine-tone track: exercises the cut executor's
  // non-video packet windowing (the reference's concat+copy also carries
  // audio through).
  AVStream *ast = nullptr;
  AVCodecContext *aenc = nullptr;
  if (with_audio) {
    const AVCodec *acodec = avcodec_find_encoder(AV_CODEC_ID_AAC);
    if (acodec) {
      aenc = avcodec_alloc_context3(acodec);
      aenc->sample_rate = 44100;
      av_channel_layout_default(&aenc->ch_layout, 1);
      aenc->sample_fmt = AV_SAMPLE_FMT_FLTP;
      aenc->bit_rate = 64000;
      aenc->time_base = AVRational{1, aenc->sample_rate};
      if (out->oformat->flags & AVFMT_GLOBALHEADER)
        aenc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
      if (avcodec_open2(aenc, acodec, nullptr) < 0) {
        // graceful video-only fallback: the stream must only be created
        // AFTER a successful open, or a codec-less stream lingers in the
        // container and write_header rejects the whole file
        avcodec_free_context(&aenc);
      } else {
        ast = avformat_new_stream(out, nullptr);
        if (!ast) {
          avcodec_free_context(&aenc);
        } else {
          avcodec_parameters_from_context(ast->codecpar, aenc);
          ast->time_base = aenc->time_base;
        }
      }
    }
  }

  if (!(out->oformat->flags & AVFMT_NOFILE)) {
    if (avio_open(&out->pb, path, AVIO_FLAG_WRITE) < 0) {
      set_err(err, errlen, "cannot open output");
      avcodec_free_context(&enc);
      avformat_free_context(out);
      return -1;
    }
  }
  if (avformat_write_header(out, nullptr) < 0) {
    set_err(err, errlen, "write_header failed");
    avcodec_free_context(&enc);
    if (out->pb) avio_closep(&out->pb);
    avformat_free_context(out);
    return -1;
  }

  AVFrame *frame = av_frame_alloc();
  frame->format = enc->pix_fmt;
  frame->width = w;
  frame->height = h;
  av_frame_get_buffer(frame, 0);
  AVPacket *pkt = av_packet_alloc();

  AVFrame *aframe = nullptr;
  int64_t audio_pts = 0;
  if (aenc) {
    aframe = av_frame_alloc();
    aframe->format = aenc->sample_fmt;
    av_channel_layout_copy(&aframe->ch_layout, &aenc->ch_layout);
    aframe->sample_rate = aenc->sample_rate;
    aframe->nb_samples = aenc->frame_size > 0 ? aenc->frame_size : 1024;
    av_frame_get_buffer(aframe, 0);
  }

  const long n_frames = static_cast<long>(duration_sec * fps);
  int rc = 0;

  auto flush_enc = [&](AVFrame *f) {
    if (avcodec_send_frame(enc, f) < 0) return -1;
    while (true) {
      int r = avcodec_receive_packet(enc, pkt);
      if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) return 0;
      if (r < 0) return -1;
      av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
      pkt->stream_index = 0;
      if (av_interleaved_write_frame(out, pkt) < 0) return -1;
    }
  };

  for (long i = 0; i < n_frames && rc == 0; i++) {
    av_frame_make_writable(frame);
    const double t = i / fps;
    bool moving = false;
    for (int k = 0; k < n_windows; k++) {
      if (t >= motion_windows[2 * k] && t < motion_windows[2 * k + 1]) {
        moving = true;
        break;
      }
    }
    // Static textured background (stripes) so P-frames have content.
    // With noise > 0, per-frame sensor-like noise is added (deterministic
    // xorshift so clips are reproducible): realistic CCTV footage is never
    // pixel-static, which stresses the MV threshold and encoder MV counts.
    uint32_t rng_state = 0x9E3779B9u ^ static_cast<uint32_t>(i * 2654435761u);
    auto xs = [&rng_state]() {
      rng_state ^= rng_state << 13;
      rng_state ^= rng_state >> 17;
      rng_state ^= rng_state << 5;
      return rng_state;
    };
    for (int y = 0; y < h; y++) {
      uint8_t *row = frame->data[0] + static_cast<size_t>(y) * frame->linesize[0];
      for (int x = 0; x < w; x++) {
        int v = 40 + ((x >> 4) + (y >> 4)) % 2 * 24;
        if (noise > 0) {
          v += static_cast<int>(xs() % (2 * noise + 1)) - noise;
          if (v < 0) v = 0;
          if (v > 255) v = 255;
        }
        row[x] = static_cast<uint8_t>(v);
      }
    }
    for (int y = 0; y < h / 2; y++) {
      std::memset(frame->data[1] + static_cast<size_t>(y) * frame->linesize[1],
                  128, static_cast<size_t>(w / 2));
      std::memset(frame->data[2] + static_cast<size_t>(y) * frame->linesize[2],
                  128, static_cast<size_t>(w / 2));
    }
    if (moving) {
      // Box sweeps horizontally, 8 px/frame: strong, unambiguous MVs.
      const int box = std::max(32, h / 6);
      const int bx = static_cast<int>(i * 8) % std::max(1, w - box);
      const int by = (h - box) / 2;
      for (int y = by; y < by + box; y++) {
        uint8_t *row =
            frame->data[0] + static_cast<size_t>(y) * frame->linesize[0];
        std::memset(row + bx, 235, static_cast<size_t>(box));
      }
    }
    frame->pts = i;
    rc = flush_enc(frame);

    // keep the audio clock caught up with the video clock
    if (aenc && rc == 0) {
      const double next_t = (i + 1) / fps;
      while (rc == 0 &&
             audio_pts < static_cast<int64_t>(next_t * aenc->sample_rate)) {
        av_frame_make_writable(aframe);
        float *sm = reinterpret_cast<float *>(aframe->data[0]);
        for (int s = 0; s < aframe->nb_samples; s++) {
          sm[s] = 0.25f * sinf(2.0f * 3.14159265f * 440.0f *
                               (audio_pts + s) / aenc->sample_rate);
        }
        aframe->pts = audio_pts;
        audio_pts += aframe->nb_samples;
        if (avcodec_send_frame(aenc, aframe) < 0) { rc = -1; break; }
        while (true) {
          int r = avcodec_receive_packet(aenc, pkt);
          if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) break;
          if (r < 0) { rc = -1; break; }
          av_packet_rescale_ts(pkt, aenc->time_base, ast->time_base);
          pkt->stream_index = ast->index;
          if (av_interleaved_write_frame(out, pkt) < 0) { rc = -1; break; }
        }
      }
    }
  }
  if (rc == 0) rc = flush_enc(nullptr);  // drain
  if (aenc && rc == 0 && avcodec_send_frame(aenc, nullptr) >= 0) {
    while (true) {
      int r = avcodec_receive_packet(aenc, pkt);
      if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) break;
      if (r < 0) break;
      av_packet_rescale_ts(pkt, aenc->time_base, ast->time_base);
      pkt->stream_index = ast->index;
      av_interleaved_write_frame(out, pkt);
    }
  }

  av_write_trailer(out);
  if (out->pb) avio_closep(&out->pb);
  av_packet_free(&pkt);
  av_frame_free(&frame);
  if (aframe) av_frame_free(&aframe);
  if (aenc) avcodec_free_context(&aenc);
  avcodec_free_context(&enc);
  avformat_free_context(out);
  if (rc != 0) set_err(err, errlen, "encode failed");
  return rc;
}

// Packet-level inspection of a container (demux only, no decode): per
// packet stream_index, dts/pts in seconds (NaN when unset), and the
// keyframe flag.  The mechanical oracle for the cut's splice invariants
// (monotonic dts per stream, keyframe-anchored video segment starts,
// audio/video interleaving) — what one would assert about a real
// `ffmpeg -f concat -c copy` output (reference mechanism
// ffmpeg_executor.cpp:94-118), validated here without the binary.
MVT_EXPORT long mvt_inspect_packets(const char *path, int32_t *out_stream,
                                    double *out_dts, double *out_pts,
                                    int32_t *out_key, long max_packets,
                                    char *err, int errlen) {
  av_log_set_level(AV_LOG_ERROR);
  AVFormatContext *in = nullptr;
  if (avformat_open_input(&in, path, nullptr, nullptr) < 0) {
    set_err(err, errlen, std::string("open failed: ") + path);
    return -1;
  }
  if (avformat_find_stream_info(in, nullptr) < 0) {
    avformat_close_input(&in);
    set_err(err, errlen, "find_stream_info failed");
    return -1;
  }
  AVPacket *pkt = av_packet_alloc();
  long n = 0;
  while (n < max_packets && av_read_frame(in, pkt) >= 0) {
    const double tb = av_q2d(in->streams[pkt->stream_index]->time_base);
    out_stream[n] = pkt->stream_index;
    out_dts[n] = (pkt->dts == AV_NOPTS_VALUE) ? NAN : pkt->dts * tb;
    out_pts[n] = (pkt->pts == AV_NOPTS_VALUE) ? NAN : pkt->pts * tb;
    out_key[n] = (pkt->flags & AV_PKT_FLAG_KEY) ? 1 : 0;
    ++n;
    av_packet_unref(pkt);
  }
  av_packet_free(&pkt);
  avformat_close_input(&in);
  return n;
}

// Per-stream codec types (0 video, 1 audio, 2 other), for interpreting
// mvt_inspect_packets stream indices.  Returns the stream count.
MVT_EXPORT int mvt_stream_types(MvtHandle *h, int32_t *out_types,
                                int max_streams) {
  if (!h) return -1;
  const int n = static_cast<int>(h->fmt->nb_streams);
  for (int i = 0; i < n && i < max_streams; ++i) {
    const AVMediaType t = h->fmt->streams[i]->codecpar->codec_type;
    out_types[i] = (t == AVMEDIA_TYPE_VIDEO)   ? 0
                   : (t == AVMEDIA_TYPE_AUDIO) ? 1
                                               : 2;
  }
  return n;
}

MVT_EXPORT const char *mvt_version() {
#ifdef MVT_LIBAV_ABI
  return "mvtrim_host 0.1.0 (FFmpeg 8 runtime, libav_abi.h declarations)";
#else
  return "mvtrim_host 0.1.0 (FFmpeg development headers)";
#endif
}

// Checks that the loaded libav matches what this library was compiled
// against.  With FFmpeg's own headers that holds by construction.  With
// libav_abi.h it checks the major versions, the offset of every declared
// field that FFmpeg also lists as an AVOption, and the defaults that
// av_frame_alloc/av_packet_alloc write at the declared offsets.  Returns 0,
// or -1 with a message in err.
MVT_EXPORT int mvt_libav_check(char *err, int errlen) {
#ifdef MVT_LIBAV_ABI
  const unsigned majors[3] = {avformat_version() >> 16,
                              avcodec_version() >> 16,
                              avutil_version() >> 16};
  if (majors[0] != 62 || majors[1] != 62 || majors[2] != 60) {
    set_err(err, errlen,
            "libav_abi.h describes libavformat 62 / libavcodec 62 / "
            "libavutil 60; loaded " + std::to_string(majors[0]) + "/" +
                std::to_string(majors[1]) + "/" + std::to_string(majors[2]));
    return -1;
  }
  struct Field {
    const AVClass *cls;
    const char *option;
    size_t offset;
  };
  const AVClass *cc = avcodec_get_class();
  const AVClass *fc = avformat_get_class();
  const AVClass *sc = av_stream_get_class();
  const Field fields[] = {
      {cc, "b", offsetof(AVCodecContext, bit_rate)},
      {cc, "flags", offsetof(AVCodecContext, flags)},
      {cc, "flags2", offsetof(AVCodecContext, flags2)},
      {cc, "time_base", offsetof(AVCodecContext, time_base)},
      {cc, "pkt_timebase", offsetof(AVCodecContext, pkt_timebase)},
      {cc, "delay", offsetof(AVCodecContext, delay)},
      {cc, "video_size", offsetof(AVCodecContext, width)},
      {cc, "pixel_format", offsetof(AVCodecContext, pix_fmt)},
      {cc, "bf", offsetof(AVCodecContext, max_b_frames)},
      {cc, "g", offsetof(AVCodecContext, gop_size)},
      {cc, "ar", offsetof(AVCodecContext, sample_rate)},
      {cc, "ch_layout", offsetof(AVCodecContext, ch_layout)},
      {cc, "frame_size", offsetof(AVCodecContext, frame_size)},
      {cc, "threads", offsetof(AVCodecContext, thread_count)},
      {cc, "thread_type", offsetof(AVCodecContext, thread_type)},
      {cc, "skip_loop_filter", offsetof(AVCodecContext, skip_loop_filter)},
      {cc, "skip_idct", offsetof(AVCodecContext, skip_idct)},
      {cc, "skip_frame", offsetof(AVCodecContext, skip_frame)},
      {fc, "packetsize", offsetof(AVFormatContext, packet_size)},
      {fc, "max_delay", offsetof(AVFormatContext, max_delay)},
      {fc, "fflags", offsetof(AVFormatContext, flags)},
      {sc, "disposition", offsetof(AVStream, disposition)},
      {sc, "discard", offsetof(AVStream, discard)},
  };
  for (const Field &f : fields) {
    const AVOption *o = av_opt_find(const_cast<const AVClass **>(&f.cls),
                                    f.option, nullptr, 0,
                                    AV_OPT_SEARCH_FAKE_OBJ);
    if (!o || o->offset != static_cast<int>(f.offset)) {
      set_err(err, errlen,
              std::string("libav_abi.h: option ") + f.option + " at " +
                  (o ? std::to_string(o->offset) : "none") + ", declared at " +
                  std::to_string(f.offset));
      return -1;
    }
  }
  AVFrame *frame = av_frame_alloc();
  AVPacket *pkt = av_packet_alloc();
  const bool defaults_ok =
      frame && pkt && frame->format == -1 &&
      frame->extended_data == frame->data &&
      frame->pts == AV_NOPTS_VALUE && frame->pkt_dts == AV_NOPTS_VALUE &&
      frame->best_effort_timestamp == AV_NOPTS_VALUE &&
      frame->time_base.den == 1 && frame->ch_layout.nb_channels == 0 &&
      pkt->pts == AV_NOPTS_VALUE && pkt->dts == AV_NOPTS_VALUE &&
      pkt->pos == -1 && pkt->time_base.den == 1;
  av_frame_free(&frame);
  av_packet_free(&pkt);
  if (!defaults_ok) {
    set_err(err, errlen,
            "libav_abi.h: AVFrame/AVPacket defaults not where declared");
    return -1;
  }
#else
  (void)err;
  (void)errlen;
#endif
  return 0;
}

// Runtime libav versions (packed FFmpeg style: (major<<16)|(minor<<8)|micro).
// The doctor tool uses these to report whether the linked FFmpeg can export
// HEVC motion vectors (avcodec major >= 61, i.e. FFmpeg >= 7 — the
// capability the reference's Dockerfile builds FFmpeg 8 from source for).
MVT_EXPORT void mvt_libav_versions(unsigned *fmt, unsigned *cod,
                                   unsigned *utl) {
  if (fmt) *fmt = avformat_version();
  if (cod) *cod = avcodec_version();
  if (utl) *utl = avutil_version();
}

// Bump whenever any exported signature changes; the ctypes loader refuses
// stale prebuilt libraries (calling with shifted arguments corrupts the
// stack silently).
// v11: mvt_scan_grids_multi grows a per-frame has_mv out-param (nullable)
// so vec_needed<=0 sweeps can apply the reference's `!sd -> false` rule,
// which a zero vote grid cannot represent.
// v12: adds mvt_libav_check (the loader refuses a libav whose layout
// differs from the one compiled against).
MVT_EXPORT int mvt_abi_version() { return 12; }

// Frame-skip modulo phase of the handle's decode position (testing aid).
MVT_EXPORT int mvt_skip_phase(MvtHandle *h) { return h ? h->skip_phase : -1; }

// Declarations of the part of FFmpeg's public C API that mvtrim_host.cpp
// uses, for the FFmpeg 8 ABI: libavformat 62, libavcodec 62, libavutil 60.
//
// The build uses FFmpeg's own headers whenever pkg-config finds them.
// This file exists for hosts that carry an FFmpeg 8 runtime but not its
// development files, such as the copy of FFmpeg bundled inside the
// opencv-python wheels (native/find_libav.py finds it); the Makefile then
// compiles with -DMVT_LIBAV_ABI and links those libraries directly.
//
// FFmpeg keeps public struct fields at fixed offsets within a major
// version, so the declarations below hold for every 62/62/60 release.
// Only the leading fields that the host code reads or writes are
// declared; every offset is pinned by a static_assert.  At run time
// mvt_libav_check() compares the offsets of every field that FFmpeg also
// describes as an AVOption with the option table of the library actually
// loaded, and the default values that av_frame_alloc/av_packet_alloc
// write, and refuses any other major version.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cerrno>

extern "C" {

// --- libavutil -------------------------------------------------------------

struct AVRational {
  int num, den;
};

static inline double av_q2d(AVRational a) {
  return a.num / static_cast<double>(a.den);
}

struct AVChannelLayout {
  int order;
  int nb_channels;
  union {
    uint64_t mask;
    void *map;
  } u;
  void *opaque;
};
static_assert(sizeof(AVChannelLayout) == 24, "AVChannelLayout");

struct AVDictionary;
struct AVBufferRef;
struct AVClass;

#define AV_NOPTS_VALUE INT64_MIN
#define AV_TIME_BASE 1000000
#define AVERROR(e) (-(e))
#define AVERROR_EOF \
  (-static_cast<int>(('E') | ('O' << 8) | ('F' << 16) | (' ' << 24)))
#define AV_LOG_ERROR 16

enum AVMediaType : int {
  AVMEDIA_TYPE_UNKNOWN = -1,
  AVMEDIA_TYPE_VIDEO = 0,
  AVMEDIA_TYPE_AUDIO = 1,
  AVMEDIA_TYPE_DATA = 2,
  AVMEDIA_TYPE_SUBTITLE = 3,
};

enum AVPictureType : int {
  AV_PICTURE_TYPE_NONE = 0,
  AV_PICTURE_TYPE_I = 1,
  AV_PICTURE_TYPE_P = 2,
  AV_PICTURE_TYPE_B = 3,
};

enum AVPixelFormat : int { AV_PIX_FMT_NONE = -1, AV_PIX_FMT_YUV420P = 0 };
enum AVSampleFormat : int { AV_SAMPLE_FMT_NONE = -1, AV_SAMPLE_FMT_FLTP = 8 };
enum AVFrameSideDataType : int { AV_FRAME_DATA_MOTION_VECTORS = 8 };

struct AVMotionVector {
  int32_t source;
  uint8_t w, h;
  int16_t src_x, src_y;
  int16_t dst_x, dst_y;
  uint64_t flags;
  int32_t motion_x, motion_y;
  uint16_t motion_scale;
};
static_assert(sizeof(AVMotionVector) == 40, "AVMotionVector");

struct AVFrameSideData {
  enum AVFrameSideDataType type;
  uint8_t *data;
  size_t size;
};

struct AVFrame {
  uint8_t *data[8];
  int linesize[8];
  uint8_t **extended_data;
  int width, height;
  int nb_samples;
  int format;
  enum AVPictureType pict_type;
  AVRational sample_aspect_ratio;
  int64_t pts;
  int64_t pkt_dts;
  AVRational time_base;
  int quality;
  void *opaque;
  int repeat_pict;
  int sample_rate;
  AVBufferRef *buf[8];
  AVBufferRef **extended_buf;
  int nb_extended_buf;
  AVFrameSideData **side_data;
  int nb_side_data;
  int flags;
  int color_range;
  int color_primaries;
  int color_trc;
  int colorspace;
  int chroma_location;
  int64_t best_effort_timestamp;
  AVDictionary *metadata;
  int decode_error_flags;
  AVBufferRef *hw_frames_ctx;
  AVBufferRef *opaque_ref;
  size_t crop_top, crop_bottom, crop_left, crop_right;
  AVBufferRef *private_ref;
  AVChannelLayout ch_layout;
  int64_t duration;
};
static_assert(offsetof(AVFrame, format) == 116, "AVFrame.format");
static_assert(offsetof(AVFrame, pts) == 136, "AVFrame.pts");
static_assert(offsetof(AVFrame, sample_rate) == 180, "AVFrame.sample_rate");
static_assert(offsetof(AVFrame, best_effort_timestamp) == 304,
              "AVFrame.best_effort_timestamp");
static_assert(offsetof(AVFrame, ch_layout) == 384, "AVFrame.ch_layout");

struct AVOption {
  const char *name;
  const char *help;
  int offset;
  int type;
  int64_t default_val;
  double min, max;
  int flags;
  const char *unit;
};
#define AV_OPT_SEARCH_FAKE_OBJ (1 << 1)

unsigned avutil_version(void);
void av_log_set_level(int level);
void *av_malloc(size_t size);
void av_free(void *ptr);
void av_freep(void *ptr);
int av_dict_set(AVDictionary **pm, const char *key, const char *value,
                int flags);
void av_dict_free(AVDictionary **m);
AVRational av_d2q(double d, int max);
int64_t av_rescale_q(int64_t a, AVRational bq, AVRational cq);
AVFrame *av_frame_alloc(void);
void av_frame_free(AVFrame **frame);
int av_frame_get_buffer(AVFrame *frame, int align);
int av_frame_make_writable(AVFrame *frame);
AVFrameSideData *av_frame_get_side_data(const AVFrame *frame,
                                        enum AVFrameSideDataType type);
int av_channel_layout_default(AVChannelLayout *ch_layout, int nb_channels);
int av_channel_layout_copy(AVChannelLayout *dst, const AVChannelLayout *src);
const AVOption *av_opt_find(void *obj, const char *name, const char *unit,
                            int opt_flags, int search_flags);

// --- libavcodec ------------------------------------------------------------

enum AVCodecID : int { AV_CODEC_ID_NONE = 0, AV_CODEC_ID_AAC = 0x15002 };

enum AVDiscard : int {
  AVDISCARD_NONE = -16,
  AVDISCARD_DEFAULT = 0,
  AVDISCARD_NONREF = 8,
  AVDISCARD_BIDIR = 16,
  AVDISCARD_NONINTRA = 24,
  AVDISCARD_NONKEY = 32,
  AVDISCARD_ALL = 48,
};

#define AV_CODEC_FLAG_GRAY (1 << 13)
#define AV_CODEC_FLAG_GLOBAL_HEADER (1 << 22)
#define AV_CODEC_FLAG2_FAST (1 << 0)
#define FF_THREAD_SLICE 2
#define AV_PKT_FLAG_KEY 0x0001

struct AVCodec;

struct AVCodecParameters {
  enum AVMediaType codec_type;
  enum AVCodecID codec_id;
  uint32_t codec_tag;
};

struct AVPacket {
  AVBufferRef *buf;
  int64_t pts;
  int64_t dts;
  uint8_t *data;
  int size;
  int stream_index;
  int flags;
  void *side_data;
  int side_data_elems;
  int64_t duration;
  int64_t pos;
  void *opaque;
  AVBufferRef *opaque_ref;
  AVRational time_base;
};
static_assert(offsetof(AVPacket, duration) == 64, "AVPacket.duration");
static_assert(offsetof(AVPacket, pos) == 72, "AVPacket.pos");

// AVCodecContext has a few hundred fields; the gaps between the ones used
// here are padding.  Every declared offset is also an AVOption offset
// (checked at run time), except framerate and sample_fmt, which sit
// between two checked fields (pkt_timebase..delay, sample_rate..ch_layout).
struct AVCodecContext {
  const AVClass *av_class;
  char pad0_[56 - 8];
  int64_t bit_rate;            // "b"
  int flags;                   // "flags"
  int flags2;                  // "flags2"
  uint8_t *extradata;
  int extradata_size;
  AVRational time_base;        // "time_base"
  AVRational pkt_timebase;     // "pkt_timebase"
  AVRational framerate;
  int delay;                   // "delay"
  int width, height;           // "video_size"
  char pad1_[136 - 120];
  enum AVPixelFormat pix_fmt;  // "pixel_format"
  char pad2_[200 - 140];
  int max_b_frames;            // "bf"
  char pad3_[332 - 204];
  int gop_size;                // "g"
  char pad4_[344 - 336];
  int sample_rate;             // "ar"
  enum AVSampleFormat sample_fmt;
  AVChannelLayout ch_layout;   // "ch_layout"
  int frame_size;              // "frame_size"
  char pad5_[656 - 380];
  int thread_count;            // "threads"
  int thread_type;             // "thread_type"
  char pad6_[700 - 664];
  enum AVDiscard skip_loop_filter;  // "skip_loop_filter"
  enum AVDiscard skip_idct;         // "skip_idct"
  enum AVDiscard skip_frame;        // "skip_frame"
};
static_assert(offsetof(AVCodecContext, bit_rate) == 56, "bit_rate");
static_assert(offsetof(AVCodecContext, time_base) == 84, "time_base");
static_assert(offsetof(AVCodecContext, framerate) == 100, "framerate");
static_assert(offsetof(AVCodecContext, width) == 112, "width");
static_assert(offsetof(AVCodecContext, pix_fmt) == 136, "pix_fmt");
static_assert(offsetof(AVCodecContext, max_b_frames) == 200, "max_b_frames");
static_assert(offsetof(AVCodecContext, gop_size) == 332, "gop_size");
static_assert(offsetof(AVCodecContext, ch_layout) == 352, "ch_layout");
static_assert(offsetof(AVCodecContext, frame_size) == 376, "frame_size");
static_assert(offsetof(AVCodecContext, thread_count) == 656, "thread_count");
static_assert(offsetof(AVCodecContext, skip_frame) == 708, "skip_frame");

unsigned avcodec_version(void);
const AVClass *avcodec_get_class(void);
const AVCodec *avcodec_find_decoder(enum AVCodecID id);
const AVCodec *avcodec_find_encoder(enum AVCodecID id);
const AVCodec *avcodec_find_encoder_by_name(const char *name);
AVCodecContext *avcodec_alloc_context3(const AVCodec *codec);
void avcodec_free_context(AVCodecContext **avctx);
int avcodec_open2(AVCodecContext *avctx, const AVCodec *codec,
                  AVDictionary **options);
int avcodec_parameters_to_context(AVCodecContext *codec,
                                  const AVCodecParameters *par);
int avcodec_parameters_from_context(AVCodecParameters *par,
                                    const AVCodecContext *codec);
int avcodec_parameters_copy(AVCodecParameters *dst,
                            const AVCodecParameters *src);
void avcodec_flush_buffers(AVCodecContext *avctx);
int avcodec_send_packet(AVCodecContext *avctx, const AVPacket *avpkt);
int avcodec_receive_frame(AVCodecContext *avctx, AVFrame *frame);
int avcodec_send_frame(AVCodecContext *avctx, const AVFrame *frame);
int avcodec_receive_packet(AVCodecContext *avctx, AVPacket *avpkt);
AVPacket *av_packet_alloc(void);
void av_packet_free(AVPacket **pkt);
void av_packet_unref(AVPacket *pkt);
void av_packet_rescale_ts(AVPacket *pkt, AVRational tb_src,
                          AVRational tb_dst);

// --- libavformat -----------------------------------------------------------

#define AVSEEK_SIZE 0x10000
#define AVSEEK_FORCE 0x20000
#define AVSEEK_FLAG_BACKWARD 1
#define AVIO_FLAG_WRITE 2
#define AVFMT_NOFILE 0x0001
#define AVFMT_GLOBALHEADER 0x0040
#define AVFMT_FLAG_CUSTOM_IO 0x0080

struct AVInputFormat;

struct AVOutputFormat {
  const char *name;
  const char *long_name;
  const char *mime_type;
  const char *extensions;
  enum AVCodecID audio_codec;
  enum AVCodecID video_codec;
  enum AVCodecID subtitle_codec;
  int flags;
};
static_assert(offsetof(AVOutputFormat, flags) == 44, "AVOutputFormat.flags");

struct AVIOContext {
  const AVClass *av_class;
  unsigned char *buffer;
};

struct AVStream {
  const AVClass *av_class;
  int index;
  int id;
  AVCodecParameters *codecpar;
  void *priv_data;
  AVRational time_base;
  int64_t start_time;
  int64_t duration;
  int64_t nb_frames;
  int disposition;             // "disposition"
  enum AVDiscard discard;      // "discard"
  AVRational sample_aspect_ratio;
  AVDictionary *metadata;
  AVRational avg_frame_rate;
};
static_assert(offsetof(AVStream, disposition) == 64, "AVStream.disposition");
static_assert(offsetof(AVStream, avg_frame_rate) == 88,
              "AVStream.avg_frame_rate");

struct AVFormatContext {
  const AVClass *av_class;
  const AVInputFormat *iformat;
  const AVOutputFormat *oformat;
  void *priv_data;
  AVIOContext *pb;
  int ctx_flags;
  unsigned int nb_streams;
  AVStream **streams;
  unsigned int nb_stream_groups;
  void **stream_groups;
  unsigned int nb_chapters;
  void **chapters;
  char *url;
  int64_t start_time;
  int64_t duration;
  int64_t bit_rate;
  unsigned int packet_size;    // "packetsize"
  int max_delay;               // "max_delay"
  int flags;                   // "fflags"
};
static_assert(offsetof(AVFormatContext, duration) == 104,
              "AVFormatContext.duration");
static_assert(offsetof(AVFormatContext, flags) == 128, "AVFormatContext.flags");

unsigned avformat_version(void);
const AVClass *avformat_get_class(void);
const AVClass *av_stream_get_class(void);
AVFormatContext *avformat_alloc_context(void);
void avformat_free_context(AVFormatContext *s);
int avformat_open_input(AVFormatContext **ps, const char *url,
                        const AVInputFormat *fmt, AVDictionary **options);
void avformat_close_input(AVFormatContext **s);
int avformat_find_stream_info(AVFormatContext *ic, AVDictionary **options);
int av_find_best_stream(AVFormatContext *ic, enum AVMediaType type,
                        int wanted_stream_nb, int related_stream,
                        const AVCodec **decoder_ret, int flags);
int av_read_frame(AVFormatContext *s, AVPacket *pkt);
int av_seek_frame(AVFormatContext *s, int stream_index, int64_t timestamp,
                  int flags);
int avformat_alloc_output_context2(AVFormatContext **ctx,
                                   const AVOutputFormat *oformat,
                                   const char *format_name,
                                   const char *filename);
AVStream *avformat_new_stream(AVFormatContext *s, const AVCodec *c);
int avformat_write_header(AVFormatContext *s, AVDictionary **options);
int av_interleaved_write_frame(AVFormatContext *s, AVPacket *pkt);
int av_write_trailer(AVFormatContext *s);
AVIOContext *avio_alloc_context(
    unsigned char *buffer, int buffer_size, int write_flag, void *opaque,
    int (*read_packet)(void *opaque, uint8_t *buf, int buf_size),
    int (*write_packet)(void *opaque, const uint8_t *buf, int buf_size),
    int64_t (*seek)(void *opaque, int64_t offset, int whence));
void avio_context_free(AVIOContext **s);
int avio_open(AVIOContext **s, const char *url, int flags);
int avio_closep(AVIOContext **s);

}  // extern "C"

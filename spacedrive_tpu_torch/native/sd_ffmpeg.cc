// Native FFmpeg wrapper: the sd-ffmpeg crate equivalent, linked — not a CLI
// subprocess. The port's copy of spacedrive_tpu/native/sd_ffmpeg.cc; it
// needs the libav* headers to build (-lavformat -lavcodec -lavutil
// -lswscale).
//
// Reference: crates/ffmpeg/src/{movie_decoder,thumbnailer}.rs — a
// MovieDecoder over libavformat/libavcodec that (a) prefers an embedded
// cover-art stream (AV_DISPOSITION_ATTACHED_PIC) when present, else (b)
// decodes one probe frame, seeks to seek_percentage of the duration
// (thumbnailer.rs ThumbnailerBuilder: seek_percentage 0.1) and decodes the
// keyframe there, then scales to the target edge via libswscale
// (create_scale_string, movie_decoder.rs:589). WebP encoding stays in
// sd_images.cc / the Python layer so the frame crosses the ABI exactly once.
//
// Also exposed:
//   sd_ffmpeg_probe_json — stream/format metadata for the media-data
//     extractor (sd-media-metadata's audio/video side, done via linked
//     libavformat instead of an ffprobe subprocess).
//   sd_ffmpeg_write_test_video — a tiny encoder (mpeg4/mpeg1video) so the
//     tests can synthesize sample videos without an ffmpeg CLI or
//     checked-in samples.
//
// All functions are C-ABI for ctypes. Errors return negative AVERROR codes;
// sd_ffmpeg_err_str renders them for Python exceptions.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

namespace {

struct QuietLogs {
  QuietLogs() { av_log_set_level(AV_LOG_ERROR); }
} quiet_logs_;

constexpr int kErrNoVideo = -900001;   // no decodable video/cover stream
constexpr int kErrBufSmall = -900002;  // caller buffer too small
constexpr int kErrEncode = -900003;    // test-encoder setup failure

struct Input {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  int stream_index = -1;
  bool attached_pic = false;

  ~Input() {
    if (dec) avcodec_free_context(&dec);
    if (fmt) avformat_close_input(&fmt);
  }
};

// Open `path` and set up a decoder for its best video stream. Mirrors
// find_preferred_video_stream (movie_decoder.rs:312): an attached_pic
// (cover art) stream wins when prefer_embedded is set, matching the
// reference's prefer_embedded_metadata default.
int open_video(const char* path, bool prefer_embedded, Input& in) {
  int rc = avformat_open_input(&in.fmt, path, nullptr, nullptr);
  if (rc < 0) return rc;
  rc = avformat_find_stream_info(in.fmt, nullptr);
  if (rc < 0) return rc;

  int best = av_find_best_stream(in.fmt, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
  if (prefer_embedded) {
    for (unsigned i = 0; i < in.fmt->nb_streams; i++) {
      AVStream* s = in.fmt->streams[i];
      if (s->codecpar->codec_type == AVMEDIA_TYPE_VIDEO &&
          (s->disposition & AV_DISPOSITION_ATTACHED_PIC)) {
        best = static_cast<int>(i);
        in.attached_pic = true;
        break;
      }
    }
  }
  if (best < 0) return kErrNoVideo;
  in.stream_index = best;

  AVCodecParameters* par = in.fmt->streams[best]->codecpar;
  const AVCodec* codec = avcodec_find_decoder(par->codec_id);
  if (!codec) return kErrNoVideo;
  in.dec = avcodec_alloc_context3(codec);
  if (!in.dec) return AVERROR(ENOMEM);
  rc = avcodec_parameters_to_context(in.dec, par);
  if (rc < 0) return rc;
  rc = avcodec_open2(in.dec, codec, nullptr);
  if (rc < 0) return rc;
  return 0;
}

// Decode frames until one comes out; caller owns the returned ref inside
// `frame`. Returns 0 on success.
int decode_next_frame(Input& in, AVFrame* frame) {
  AVPacket* pkt = av_packet_alloc();
  if (!pkt) return AVERROR(ENOMEM);
  int rc;
  for (;;) {
    rc = avcodec_receive_frame(in.dec, frame);
    if (rc == 0) break;
    if (rc != AVERROR(EAGAIN)) break;
    rc = av_read_frame(in.fmt, pkt);
    if (rc < 0) {  // EOF: flush the decoder once
      avcodec_send_packet(in.dec, nullptr);
      rc = avcodec_receive_frame(in.dec, frame);
      break;
    }
    if (pkt->stream_index == in.stream_index) {
      rc = avcodec_send_packet(in.dec, pkt);
      av_packet_unref(pkt);
      if (rc < 0 && rc != AVERROR(EAGAIN)) break;
    } else {
      av_packet_unref(pkt);
    }
  }
  av_packet_free(&pkt);
  return rc == 0 ? 0 : (rc < 0 ? rc : kErrNoVideo);
}

// Fixed-point 3-decimal formatting via integer math: snprintf("%f") obeys
// LC_NUMERIC, and an embedding host that called setlocale() to a comma-
// decimal locale would make the probe emit invalid JSON.
void append_fixed3(std::string& out, double v) {
  if (v < 0) {
    out += '-';
    v = -v;
  }
  auto milli = static_cast<long long>(v * 1000.0 + 0.5);
  char buf[64];
  snprintf(buf, sizeof buf, "%lld.%03lld", milli / 1000, milli % 1000);
  out += buf;
}

void json_escape(std::string& out, const char* s) {
  for (; *s; s++) {
    unsigned char c = static_cast<unsigned char>(*s);
    if (c == '"' || c == '\\') {
      out += '\\';
      out += static_cast<char>(c);
    } else if (c < 0x20) {
      char buf[8];
      snprintf(buf, sizeof buf, "\\u%04x", c);
      out += buf;
    } else {
      out += static_cast<char>(c);
    }
  }
}

}  // namespace

extern "C" {

// Render an error code (AVERROR or kErr*) into `out`.
void sd_ffmpeg_err_str(int code, char* out, int cap) {
  switch (code) {
    case kErrNoVideo:
      snprintf(out, cap, "no decodable video stream");
      return;
    case kErrBufSmall:
      snprintf(out, cap, "output buffer too small");
      return;
    case kErrEncode:
      snprintf(out, cap, "encoder setup failed");
      return;
    default:
      if (av_strerror(code, out, cap) < 0) snprintf(out, cap, "av error %d", code);
  }
}

// Probe format + streams into a JSON document (the extractor's input).
// Returns bytes written (excluding NUL) or a negative error.
int64_t sd_ffmpeg_probe_json(const char* path, char* out, int64_t cap) {
  Input in;
  int rc = avformat_open_input(&in.fmt, path, nullptr, nullptr);
  if (rc < 0) return rc;
  rc = avformat_find_stream_info(in.fmt, nullptr);
  if (rc < 0) return rc;

  std::string j = "{";
  char buf[256];
  if (in.fmt->iformat && in.fmt->iformat->name) {
    j += "\"format\":\"";
    json_escape(j, in.fmt->iformat->name);
    j += "\",";
  }
  if (in.fmt->duration > 0) {
    j += "\"duration_seconds\":";
    append_fixed3(j, static_cast<double>(in.fmt->duration) / AV_TIME_BASE);
    j += ",";
  }
  if (in.fmt->bit_rate > 0) {
    snprintf(buf, sizeof buf, "\"bit_rate\":%lld,",
             static_cast<long long>(in.fmt->bit_rate));
    j += buf;
  }
  // container tags the extractor maps to MediaData columns
  j += "\"tags\":{";
  bool first_tag = true;
  const AVDictionaryEntry* tag = nullptr;
  while ((tag = av_dict_get(in.fmt->metadata, "", tag, AV_DICT_IGNORE_SUFFIX))) {
    if (!first_tag) j += ",";
    first_tag = false;
    j += '"';
    json_escape(j, tag->key);
    j += "\":\"";
    json_escape(j, tag->value);
    j += '"';
  }
  j += "},\"streams\":[";
  for (unsigned i = 0; i < in.fmt->nb_streams; i++) {
    AVStream* s = in.fmt->streams[i];
    AVCodecParameters* par = s->codecpar;
    if (i) j += ",";
    j += "{\"codec_type\":\"";
    const char* type = av_get_media_type_string(par->codec_type);
    json_escape(j, type ? type : "unknown");
    j += "\"";
    const char* codec = avcodec_get_name(par->codec_id);
    if (codec) {
      j += ",\"codec\":\"";
      json_escape(j, codec);
      j += "\"";
    }
    if (par->codec_type == AVMEDIA_TYPE_VIDEO) {
      snprintf(buf, sizeof buf, ",\"width\":%d,\"height\":%d", par->width,
               par->height);
      j += buf;
      AVRational fr = s->avg_frame_rate;
      if (fr.num > 0 && fr.den > 0) {
        j += ",\"fps\":";
        append_fixed3(j, av_q2d(fr));
      }
      if (s->disposition & AV_DISPOSITION_ATTACHED_PIC)
        j += ",\"attached_pic\":true";
    } else if (par->codec_type == AVMEDIA_TYPE_AUDIO) {
      snprintf(buf, sizeof buf, ",\"channels\":%d,\"sample_rate\":%d",
#if LIBAVCODEC_VERSION_MAJOR >= 59
               par->ch_layout.nb_channels,
#else
               par->channels,
#endif
               par->sample_rate);
      j += buf;
    }
    j += "}";
  }
  j += "]}";
  if (static_cast<int64_t>(j.size()) + 1 > cap) return kErrBufSmall;
  memcpy(out, j.data(), j.size() + 1);
  return static_cast<int64_t>(j.size());
}

// Decode one representative frame as packed RGB24.
//
// seek_percent ∈ [0,1): position in the stream (thumbnailer.rs seeks to
// 0.1 × duration after a probe frame; attached cover art never seeks).
// target_edge > 0 scales so max(w,h) == min(target_edge, native edge),
// preserving aspect (create_scale_string semantics). Returns bytes written
// (w*h*3) with *out_w/*out_h set, or a negative error.
int64_t sd_ffmpeg_decode_frame_rgb(const char* path, double seek_percent,
                                   int32_t target_edge, uint8_t* out,
                                   int64_t cap, int32_t* out_w,
                                   int32_t* out_h) {
  Input in;
  int rc = open_video(path, /*prefer_embedded=*/true, in);
  if (rc < 0) return rc;

  AVFrame* frame = av_frame_alloc();
  if (!frame) return AVERROR(ENOMEM);

  // probe frame first — some demuxers only report usable metadata after one
  // decoded frame (thumbnailer.rs:55 "have to decode a frame to get some
  // metadata"); then seek and decode the real target frame
  rc = decode_next_frame(in, frame);
  if (rc == 0 && !in.attached_pic && seek_percent > 0 &&
      in.fmt->duration > 0) {
    int64_t ts = static_cast<int64_t>(in.fmt->duration * seek_percent);
    if (av_seek_frame(in.fmt, -1, ts, AVSEEK_FLAG_BACKWARD) >= 0) {
      avcodec_flush_buffers(in.dec);
      av_frame_unref(frame);
      if (decode_next_frame(in, frame) < 0) {
        // seek landed nowhere decodable — fall back to the first frame,
        // like thumbnailer.rs's "seeking failed, try the first frame again"
        av_frame_free(&frame);
        return sd_ffmpeg_decode_frame_rgb(path, 0.0, target_edge, out, cap,
                                          out_w, out_h);
      }
    }
  }
  if (rc < 0) {
    av_frame_free(&frame);
    return rc;
  }

  int w = frame->width, h = frame->height;
  if (w <= 0 || h <= 0) {
    av_frame_free(&frame);
    return kErrNoVideo;
  }
  int tw = w, th = h;
  int edge = std::max(w, h);
  if (target_edge > 0 && edge > target_edge) {
    tw = std::max(1, w * target_edge / edge);
    th = std::max(1, h * target_edge / edge);
  }

  SwsContext* sws = sws_getContext(
      w, h, static_cast<AVPixelFormat>(frame->format), tw, th,
      AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr, nullptr, nullptr);
  if (!sws) {
    av_frame_free(&frame);
    return kErrNoVideo;
  }
  int64_t need = static_cast<int64_t>(tw) * th * 3;
  if (need > cap) {
    sws_freeContext(sws);
    av_frame_free(&frame);
    return kErrBufSmall;
  }
  uint8_t* dst[4] = {out, nullptr, nullptr, nullptr};
  int dst_stride[4] = {tw * 3, 0, 0, 0};
  sws_scale(sws, frame->data, frame->linesize, 0, h, dst, dst_stride);
  sws_freeContext(sws);
  av_frame_free(&frame);
  *out_w = tw;
  *out_h = th;
  return need;
}

// Synthesize a short test video: per-frame color gradient, yuv420p.
// Muxer chosen from the filename (.mp4 → mpeg4, .mpg → mpeg1video, else
// whatever the container's default video codec is). Test-only helper.
int32_t sd_ffmpeg_write_test_video(const char* path, int32_t w, int32_t h,
                                   int32_t nframes, int32_t fps) {
  if (w <= 0 || h <= 0 || (w | h) & 1) return kErrEncode;  // yuv420p: even dims
  AVFormatContext* fmt = nullptr;
  if (avformat_alloc_output_context2(&fmt, nullptr, nullptr, path) < 0 || !fmt)
    return kErrEncode;

  AVCodecID codec_id = fmt->oformat->video_codec;
  if (codec_id == AV_CODEC_ID_NONE) codec_id = AV_CODEC_ID_MPEG4;
  const AVCodec* codec = avcodec_find_encoder(codec_id);
  if (!codec) codec = avcodec_find_encoder(AV_CODEC_ID_MPEG4);
  if (!codec) {
    avformat_free_context(fmt);
    return kErrEncode;
  }

  AVStream* stream = avformat_new_stream(fmt, nullptr);
  AVCodecContext* enc = avcodec_alloc_context3(codec);
  AVFrame* frame = av_frame_alloc();
  AVPacket* pkt = av_packet_alloc();
  SwsContext* sws = nullptr;
  uint8_t* rgb = nullptr;
  int rc = kErrEncode;

  if (!stream || !enc || !frame || !pkt) goto done;
  // MPEG-1/2 accept only standard frame rates
  if (codec->id == AV_CODEC_ID_MPEG1VIDEO || codec->id == AV_CODEC_ID_MPEG2VIDEO)
    fps = 25;
  enc->width = w;
  enc->height = h;
  enc->pix_fmt = AV_PIX_FMT_YUV420P;
  enc->time_base = AVRational{1, fps};
  enc->framerate = AVRational{fps, 1};
  enc->bit_rate = 400000;
  enc->gop_size = 12;
  if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
    enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(enc, codec, nullptr) < 0) goto done;
  if (avcodec_parameters_from_context(stream->codecpar, enc) < 0) goto done;
  stream->time_base = enc->time_base;

  if (!(fmt->oformat->flags & AVFMT_NOFILE) &&
      avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0)
    goto done;
  if (avformat_write_header(fmt, nullptr) < 0) goto done;

  frame->format = AV_PIX_FMT_YUV420P;
  frame->width = w;
  frame->height = h;
  if (av_frame_get_buffer(frame, 0) < 0) goto done;
  sws = sws_getContext(w, h, AV_PIX_FMT_RGB24, w, h, AV_PIX_FMT_YUV420P,
                       SWS_BILINEAR, nullptr, nullptr, nullptr);
  rgb = static_cast<uint8_t*>(av_malloc(static_cast<size_t>(w) * h * 3));
  if (!sws || !rgb) goto done;

  for (int i = 0; i < nframes; i++) {
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++) {
        uint8_t* p = rgb + (static_cast<size_t>(y) * w + x) * 3;
        p[0] = static_cast<uint8_t>((x * 255 / w + i * 16) & 0xff);
        p[1] = static_cast<uint8_t>((y * 255 / h) & 0xff);
        p[2] = static_cast<uint8_t>((i * 32) & 0xff);
      }
    if (av_frame_make_writable(frame) < 0) goto done;
    {
      const uint8_t* src[4] = {rgb, nullptr, nullptr, nullptr};
      int src_stride[4] = {w * 3, 0, 0, 0};
      sws_scale(sws, src, src_stride, 0, h, frame->data, frame->linesize);
    }
    frame->pts = i;
    if (avcodec_send_frame(enc, frame) < 0) goto done;
    while (avcodec_receive_packet(enc, pkt) == 0) {
      av_packet_rescale_ts(pkt, enc->time_base, stream->time_base);
      pkt->stream_index = stream->index;
      av_interleaved_write_frame(fmt, pkt);
    }
  }
  avcodec_send_frame(enc, nullptr);  // flush
  while (avcodec_receive_packet(enc, pkt) == 0) {
    av_packet_rescale_ts(pkt, enc->time_base, stream->time_base);
    pkt->stream_index = stream->index;
    av_interleaved_write_frame(fmt, pkt);
  }
  av_write_trailer(fmt);
  rc = 0;

done:
  if (rgb) av_free(rgb);
  if (sws) sws_freeContext(sws);
  av_packet_free(&pkt);
  av_frame_free(&frame);
  if (enc) avcodec_free_context(&enc);
  if (fmt) {
    if (!(fmt->oformat->flags & AVFMT_NOFILE) && fmt->pb) avio_closep(&fmt->pb);
    avformat_free_context(fmt);
  }
  return rc;
}

}  // extern "C"

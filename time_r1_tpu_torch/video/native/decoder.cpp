// Native video decoder of the PyTorch port (its own copy of the JAX
// package's `video/native/decoder.cpp`, the same code): the decord capability
// the upstream code gets from its C++/FFmpeg dependency
// (vision_process.py:249-334, src/vllm_inference/utils.py:13-57).
//
// FFmpeg (libavformat/libavcodec/libswscale) based, exposed through a plain
// C ABI consumed via ctypes (video/decoder.py builds it with g++ at first
// use). Semantics:
//  - open: builds a frame index (count + average fps like decord's
//    len(vr) / vr.get_avg_fps()).
//  - get_batch(indices): decodes exactly the requested frame indices in
//    ascending order with seek-ahead, converting to RGB24 HWC uint8.
//
// Thread model: one handle == one demuxer+decoder; callers parallelize over
// videos.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

namespace {

struct Decoder {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  SwsContext* sws = nullptr;
  int stream_idx = -1;
  int width = 0;
  int height = 0;
  double avg_fps = 0.0;
  int64_t n_frames = 0;
  // monotonically increasing decode cursor (frame count already emitted)
  int64_t next_frame = 0;
  std::string error;
};

int open_codec(Decoder* d) {
  const AVCodec* dec = avcodec_find_decoder(d->fmt->streams[d->stream_idx]->codecpar->codec_id);
  if (!dec) return -1;
  d->codec = avcodec_alloc_context3(dec);
  if (!d->codec) return -1;
  if (avcodec_parameters_to_context(d->codec, d->fmt->streams[d->stream_idx]->codecpar) < 0)
    return -1;
  d->codec->thread_count = 0;  // auto
  d->codec->thread_type = FF_THREAD_FRAME | FF_THREAD_SLICE;
  if (avcodec_open2(d->codec, dec, nullptr) < 0) return -1;
  return 0;
}

// Count frames by demuxing packets when metadata lacks nb_frames.
int64_t count_frames(Decoder* d) {
  AVStream* st = d->fmt->streams[d->stream_idx];
  if (st->nb_frames > 0) return st->nb_frames;
  // estimate from duration × fps; fall back to a packet scan
  double fps = d->avg_fps;
  if (st->duration > 0 && fps > 0) {
    double dur = st->duration * av_q2d(st->time_base);
    int64_t est = (int64_t)(dur * fps + 0.5);
    if (est > 0) return est;
  }
  // packet scan (slow path; rewinds afterwards)
  AVPacket* pkt = av_packet_alloc();
  int64_t n = 0;
  while (av_read_frame(d->fmt, pkt) >= 0) {
    if (pkt->stream_index == d->stream_idx) n++;
    av_packet_unref(pkt);
  }
  av_packet_free(&pkt);
  av_seek_frame(d->fmt, d->stream_idx, 0, AVSEEK_FLAG_BACKWARD);
  avcodec_flush_buffers(d->codec);
  return n;
}

int seek_to_start(Decoder* d) {
  if (av_seek_frame(d->fmt, d->stream_idx, 0, AVSEEK_FLAG_BACKWARD) < 0) return -1;
  avcodec_flush_buffers(d->codec);
  d->next_frame = 0;
  return 0;
}

}  // namespace

extern "C" {

// Returns an opaque handle (0 on failure). Out params: n_frames, avg_fps, h, w.
void* vd_open(const char* path, int64_t* n_frames, double* avg_fps, int* height, int* width) {
  av_log_set_level(AV_LOG_ERROR);
  Decoder* d = new Decoder();
  if (avformat_open_input(&d->fmt, path, nullptr, nullptr) < 0) {
    delete d;
    return nullptr;
  }
  if (avformat_find_stream_info(d->fmt, nullptr) < 0) {
    avformat_close_input(&d->fmt);
    delete d;
    return nullptr;
  }
  d->stream_idx = av_find_best_stream(d->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
  if (d->stream_idx < 0 || open_codec(d) < 0) {
    if (d->fmt) avformat_close_input(&d->fmt);
    delete d;
    return nullptr;
  }
  AVStream* st = d->fmt->streams[d->stream_idx];
  AVRational afr = st->avg_frame_rate.num ? st->avg_frame_rate : st->r_frame_rate;
  d->avg_fps = afr.den ? av_q2d(afr) : 0.0;
  d->width = d->codec->width;
  d->height = d->codec->height;
  d->n_frames = count_frames(d);
  *n_frames = d->n_frames;
  *avg_fps = d->avg_fps;
  *height = d->height;
  *width = d->width;
  return d;
}

// Decode frames at `indices` (ascending, may repeat) into `out`
// (n × height × width × 3, RGB24 uint8). Returns 0 on success.
//
// `tolerant` != 0 selects the FALLBACK decode mode (the second backend the
// reference gets from torchvision, vision_process.py:362-368): per-frame
// decode errors are skipped instead of aborting the batch, and missing
// frames are backfilled by the caller from the last good frame — a
// partially-corrupt video degrades instead of dropping the eval item.
static int get_batch_impl(void* handle, const int64_t* indices, int64_t n, uint8_t* out,
                          int tolerant) {
  Decoder* d = static_cast<Decoder*>(handle);
  if (!d || n <= 0) return -1;

  // ensure ascending processing; duplicates are served from the same frame
  for (int64_t i = 1; i < n; i++)
    if (indices[i] < indices[i - 1]) return -2;

  if (indices[0] < d->next_frame) {
    if (seek_to_start(d) < 0) return -3;
  }

  if (!d->sws) {
    d->sws = sws_getContext(d->width, d->height, d->codec->pix_fmt, d->width, d->height,
                            AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr, nullptr, nullptr);
    if (!d->sws) return -4;
  }

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  const int64_t frame_bytes = (int64_t)d->height * d->width * 3;
  int64_t want = 0;  // index into `indices`
  int ret = 0;
  bool eof_sent = false;

  auto emit = [&](AVFrame* f) {
    // convert this decoded frame for every requested duplicate index
    uint8_t* dst_planes[1];
    int dst_stride[1] = {d->width * 3};
    while (want < n && indices[want] == d->next_frame) {
      dst_planes[0] = out + want * frame_bytes;
      sws_scale(d->sws, f->data, f->linesize, 0, d->height, dst_planes, dst_stride);
      want++;
    }
    d->next_frame++;
  };

  while (want < n) {
    int r = av_read_frame(d->fmt, pkt);
    if (r < 0) {
      if (!eof_sent) {
        avcodec_send_packet(d->codec, nullptr);  // flush
        eof_sent = true;
      }
    } else if (pkt->stream_index != d->stream_idx) {
      av_packet_unref(pkt);
      continue;
    } else {
      avcodec_send_packet(d->codec, pkt);
      av_packet_unref(pkt);
    }
    while (true) {
      int rr = avcodec_receive_frame(d->codec, frame);
      if (rr == AVERROR(EAGAIN)) break;
      if (rr == AVERROR_EOF) {
        // stream exhausted: serve any remaining wanted indices (beyond the
        // real frame count) with the last decoded frame by clamping
        ret = (want < n) ? 1 : 0;
        goto done;
      }
      if (rr < 0) {
        if (tolerant) {
          // corrupt frame: drop it, keep the cursor honest, decode on;
          // indices that wanted the dropped frame become unservable — skip
          // them (their output rows stay zeroed for the caller to backfill)
          avcodec_flush_buffers(d->codec);
          d->next_frame++;
          while (want < n && indices[want] < d->next_frame) want++;
          ret = 1;
          break;
        }
        ret = -5;
        goto done;
      }
      emit(frame);
      av_frame_unref(frame);
      if (want >= n) goto done;
    }
    if (eof_sent && r < 0) {
      ret = (want < n) ? 1 : 0;
      break;
    }
  }
done:
  av_frame_free(&frame);
  av_packet_free(&pkt);
  // ret==1: some indices past EOF — caller clamps (duplicates last frame)
  return ret;
}

int vd_get_batch(void* handle, const int64_t* indices, int64_t n, uint8_t* out) {
  return get_batch_impl(handle, indices, n, out, 0);
}

int vd_get_batch_tolerant(void* handle, const int64_t* indices, int64_t n, uint8_t* out) {
  return get_batch_impl(handle, indices, n, out, 1);
}

void vd_close(void* handle) {
  Decoder* d = static_cast<Decoder*>(handle);
  if (!d) return;
  if (d->sws) sws_freeContext(d->sws);
  if (d->codec) avcodec_free_context(&d->codec);
  if (d->fmt) avformat_close_input(&d->fmt);
  delete d;
}

}  // extern "C"

// In-process compressed-audio codec for the host IO runtime.
//
// The reference decodes/encodes non-WAV formats by shelling out to an
// ffmpeg binary through pydub (shennong/audio.py:276-281, :318-320).
// This image carries no ffmpeg binary, but the system libav*
// libraries are present, so the framework talks to them directly:
// one process, no pipe serialization, and exact control over the
// output sample format (interleaved int16, the Kaldi convention used
// by every processor).
//
// Exposed C API (bound from native/__init__.py via ctypes):
//   shennong_codec_scan    metadata without a full decode
//   shennong_codec_decode  whole-file decode to int16 (malloc'd)
//   shennong_codec_free    release a decode buffer
//   shennong_codec_encode  int16 PCM -> any muxable audio format
//
// Built as its own shared object (libshennong_codec.so) so that a
// missing libavformat never takes down the base IO library.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/audio_fifo.h>
#include <libavutil/channel_layout.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// keep decoder/encoder chatter (timestamp bookkeeping warnings on
// gapless mp3, ...) off the CLI's stderr; real failures still print
struct LogLevelInit {
    LogLevelInit() { av_log_set_level(AV_LOG_ERROR); }
} log_level_init;

// RAII-ish cleanup helper for the decode path
struct DecodeContext {
    AVFormatContext* fmt = nullptr;
    AVCodecContext* dec = nullptr;
    SwrContext* swr = nullptr;
    AVPacket* pkt = nullptr;
    AVFrame* frame = nullptr;
    int stream_index = -1;

    ~DecodeContext() {
        if (frame) av_frame_free(&frame);
        if (pkt) av_packet_free(&pkt);
        if (swr) swr_free(&swr);
        if (dec) avcodec_free_context(&dec);
        if (fmt) avformat_close_input(&fmt);
    }

    // open the container + the best audio stream decoder
    int open(const char* path) {
        if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0)
            return -1;
        if (avformat_find_stream_info(fmt, nullptr) < 0)
            return -1;

        const AVCodec* codec = nullptr;
        stream_index = av_find_best_stream(
            fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
        if (stream_index < 0 || !codec)
            return -1;

        dec = avcodec_alloc_context3(codec);
        if (!dec)
            return -1;
        if (avcodec_parameters_to_context(
                dec, fmt->streams[stream_index]->codecpar) < 0)
            return -1;
        if (avcodec_open2(dec, codec, nullptr) < 0)
            return -1;

        pkt = av_packet_alloc();
        frame = av_frame_alloc();
        return (pkt && frame) ? 0 : -1;
    }
};

// lazily create the to-int16 resampler once the first decoded frame
// reveals the actual sample format / layout
SwrContext* make_swr_to_s16(AVFrame* frame) {
    SwrContext* swr = nullptr;
    AVChannelLayout out_layout;
    av_channel_layout_copy(&out_layout, &frame->ch_layout);
    if (swr_alloc_set_opts2(
            &swr, &out_layout, AV_SAMPLE_FMT_S16, frame->sample_rate,
            &frame->ch_layout, (AVSampleFormat)frame->format,
            frame->sample_rate, 0, nullptr) < 0) {
        av_channel_layout_uninit(&out_layout);
        return nullptr;
    }
    av_channel_layout_uninit(&out_layout);
    if (swr_init(swr) < 0) {
        swr_free(&swr);
        return nullptr;
    }
    return swr;
}

}  // namespace

extern "C" {

// Metadata probe: channels, sample rate, and an nsamples estimate
// from the container duration (exact count requires a decode; the
// reference's ffmpeg-based scan estimates the same way,
// shennong/audio.py:226-233). Returns 0 on success.
int shennong_codec_scan(
        const char* path, int32_t* channels, int32_t* rate,
        int64_t* nsamples) {
    DecodeContext ctx;
    if (ctx.open(path) != 0)
        return -1;

    *channels = ctx.dec->ch_layout.nb_channels;
    *rate = ctx.dec->sample_rate;
    if (*channels <= 0 || *rate <= 0)
        return -1;

    const AVStream* stream = ctx.fmt->streams[ctx.stream_index];
    if (stream->duration > 0) {
        *nsamples = av_rescale_q(
            stream->duration, stream->time_base,
            AVRational{1, *rate});
    } else if (ctx.fmt->duration > 0) {
        *nsamples = av_rescale(ctx.fmt->duration, *rate, AV_TIME_BASE);
    } else {
        *nsamples = 0;  // unknown; caller decodes to find out
    }
    return 0;
}

// Whole-file decode to interleaved int16 at the stream's native rate
// and channel count. Returns a malloc'd buffer of
// (*nframes * *channels) int16 samples, or nullptr on failure. The
// caller owns the buffer and releases it with shennong_codec_free.
int16_t* shennong_codec_decode(
        const char* path, int64_t* nframes, int32_t* channels,
        int32_t* rate) {
    DecodeContext ctx;
    if (ctx.open(path) != 0)
        return nullptr;

    std::vector<int16_t> samples;
    int out_channels = 0;
    int out_rate = 0;

    auto drain_frame = [&]() -> int {
        if (!ctx.swr) {
            ctx.swr = make_swr_to_s16(ctx.frame);
            if (!ctx.swr)
                return -1;
            out_channels = ctx.frame->ch_layout.nb_channels;
            out_rate = ctx.frame->sample_rate;
        }
        const int64_t capacity =
            swr_get_out_samples(ctx.swr, ctx.frame->nb_samples);
        const size_t offset = samples.size();
        samples.resize(offset + capacity * out_channels);
        uint8_t* out_plane =
            reinterpret_cast<uint8_t*>(samples.data() + offset);
        const int got = swr_convert(
            ctx.swr, &out_plane, (int)capacity,
            const_cast<const uint8_t**>(ctx.frame->extended_data),
            ctx.frame->nb_samples);
        if (got < 0)
            return -1;
        samples.resize(offset + (size_t)got * out_channels);
        return 0;
    };

    // demux/decode loop, then flush the decoder
    bool input_done = false;
    while (true) {
        if (!input_done) {
            const int read = av_read_frame(ctx.fmt, ctx.pkt);
            if (read < 0) {
                input_done = true;
                avcodec_send_packet(ctx.dec, nullptr);  // enter flush
            } else {
                if (ctx.pkt->stream_index == ctx.stream_index) {
                    int sent = avcodec_send_packet(ctx.dec, ctx.pkt);
                    if (sent == AVERROR(EAGAIN)) {
                        // decoder full: drain then retry so the
                        // packet's audio is never silently dropped
                        int rcv;
                        while ((rcv = avcodec_receive_frame(
                                    ctx.dec, ctx.frame)) == 0) {
                            if (drain_frame() != 0) {
                                av_packet_unref(ctx.pkt);
                                return nullptr;
                            }
                            av_frame_unref(ctx.frame);
                        }
                        sent = avcodec_send_packet(ctx.dec, ctx.pkt);
                    }
                    // a corrupt mid-stream packet (e.g.
                    // AVERROR_INVALIDDATA) is skipped: keep the
                    // audio decoded so far rather than failing the
                    // whole file; only a decoder still refusing
                    // input after a full drain is fatal
                    if (sent == AVERROR(EAGAIN)) {
                        av_packet_unref(ctx.pkt);
                        return nullptr;
                    }
                }
                av_packet_unref(ctx.pkt);
            }
        }
        int ret;
        while ((ret = avcodec_receive_frame(ctx.dec, ctx.frame)) == 0) {
            if (drain_frame() != 0)
                return nullptr;
            av_frame_unref(ctx.frame);
        }
        if (ret == AVERROR_EOF)
            break;
        if (ret != AVERROR(EAGAIN))
            return nullptr;
        if (input_done && ret == AVERROR(EAGAIN))
            break;
    }

    if (out_channels == 0 || samples.empty())
        return nullptr;

    *nframes = (int64_t)(samples.size() / out_channels);
    *channels = out_channels;
    *rate = out_rate;
    int16_t* out =
        static_cast<int16_t*>(std::malloc(samples.size() * sizeof(int16_t)));
    if (!out)
        return nullptr;
    std::memcpy(out, samples.data(), samples.size() * sizeof(int16_t));
    return out;
}

void shennong_codec_free(int16_t* buffer) { std::free(buffer); }

// Encode interleaved int16 PCM into any audio container/codec that
// libavformat can mux, selected from the output filename (mp3, flac,
// ogg, ...). Returns 0 on success.
int shennong_codec_encode(
        const char* path, const int16_t* data, int64_t nframes,
        int32_t channels, int32_t rate) {
    AVFormatContext* fmt = nullptr;
    AVCodecContext* enc = nullptr;
    SwrContext* swr = nullptr;
    AVAudioFifo* fifo = nullptr;
    AVPacket* pkt = nullptr;
    AVFrame* frame = nullptr;
    uint8_t** staging = nullptr;
    int staging_linesize = 0;
    int status = -1;
    bool header_written = false;

    // everything below funnels through this cleanup on return
    auto cleanup = [&]() {
        if (staging) {
            av_freep(&staging[0]);
            av_freep(&staging);
        }
        if (frame) av_frame_free(&frame);
        if (pkt) av_packet_free(&pkt);
        if (fifo) av_audio_fifo_free(fifo);
        if (swr) swr_free(&swr);
        if (enc) avcodec_free_context(&enc);
        if (fmt) {
            if (fmt->pb && !(fmt->oformat->flags & AVFMT_NOFILE))
                avio_closep(&fmt->pb);
            avformat_free_context(fmt);
        }
    };

    do {
        if (avformat_alloc_output_context2(&fmt, nullptr, nullptr, path) < 0
                || !fmt)
            break;
        const AVCodec* codec =
            avcodec_find_encoder(fmt->oformat->audio_codec);
        if (!codec)
            break;

        enc = avcodec_alloc_context3(codec);
        if (!enc)
            break;
        enc->sample_rate = rate;
        if (codec->supported_samplerates) {
            bool ok = false;
            for (const int* sr = codec->supported_samplerates; *sr; ++sr)
                ok |= (*sr == rate);
            if (!ok)
                break;  // do not silently resample: the caller's rate
                        // is part of the data contract
        }
        av_channel_layout_default(&enc->ch_layout, channels);
        enc->sample_fmt = codec->sample_fmts
            ? codec->sample_fmts[0] : AV_SAMPLE_FMT_S16;
        // scale the bitrate with the signal bandwidth: a fixed 192k
        // is outside the valid range of vorbis/mp3 at low rates
        {
            int64_t bps = (int64_t)4 * rate * channels;
            if (bps < 32000) bps = 32000;
            if (bps > 192000) bps = 192000;
            enc->bit_rate = bps;
        }
        enc->time_base = AVRational{1, rate};
        if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
            enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
        if (avcodec_open2(enc, codec, nullptr) < 0)
            break;

        AVStream* stream = avformat_new_stream(fmt, nullptr);
        if (!stream
                || avcodec_parameters_from_context(
                       stream->codecpar, enc) < 0)
            break;
        stream->time_base = enc->time_base;

        if (!(fmt->oformat->flags & AVFMT_NOFILE)
                && avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0)
            break;
        if (avformat_write_header(fmt, nullptr) < 0)
            break;
        header_written = true;

        // int16 interleaved -> encoder sample format, buffered in a
        // fifo so the encoder always sees full frame_size frames
        AVChannelLayout in_layout;
        av_channel_layout_default(&in_layout, channels);
        if (swr_alloc_set_opts2(
                &swr, &enc->ch_layout, enc->sample_fmt, rate,
                &in_layout, AV_SAMPLE_FMT_S16, rate, 0, nullptr) < 0) {
            av_channel_layout_uninit(&in_layout);
            break;
        }
        av_channel_layout_uninit(&in_layout);
        if (swr_init(swr) < 0)
            break;

        fifo = av_audio_fifo_alloc(enc->sample_fmt, channels, 1);
        pkt = av_packet_alloc();
        frame = av_frame_alloc();
        if (!fifo || !pkt || !frame)
            break;

        const int frame_size =
            (enc->frame_size > 0) ? enc->frame_size : 4096;
        frame->nb_samples = frame_size;
        frame->format = enc->sample_fmt;
        frame->sample_rate = rate;
        if (av_channel_layout_copy(&frame->ch_layout, &enc->ch_layout) < 0
                || av_frame_get_buffer(frame, 0) < 0)
            break;

        if (av_samples_alloc_array_and_samples(
                &staging, &staging_linesize, channels, frame_size,
                enc->sample_fmt, 0) < 0)
            break;

        auto send_and_mux = [&](AVFrame* to_send) -> int {
            if (avcodec_send_frame(enc, to_send) < 0)
                return -1;
            int ret;
            while ((ret = avcodec_receive_packet(enc, pkt)) == 0) {
                av_packet_rescale_ts(
                    pkt, enc->time_base, stream->time_base);
                pkt->stream_index = stream->index;
                if (av_interleaved_write_frame(fmt, pkt) < 0)
                    return -1;
            }
            return (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF)
                ? 0 : -1;
        };

        // feed the PCM through swr -> fifo -> fixed-size frames
        int64_t pts = 0;
        int64_t consumed = 0;
        bool failed = false;
        while (consumed < nframes || av_audio_fifo_size(fifo) > 0) {
            if (consumed < nframes) {
                const int chunk = (int)((nframes - consumed) < frame_size
                                        ? (nframes - consumed)
                                        : frame_size);
                const uint8_t* in_plane = reinterpret_cast<const uint8_t*>(
                    data + consumed * channels);
                const int got = swr_convert(
                    swr, staging, frame_size, &in_plane, chunk);
                if (got < 0
                        || av_audio_fifo_write(
                               fifo, (void**)staging, got) < got) {
                    failed = true;
                    break;
                }
                consumed += chunk;
            }
            const bool flush_input = (consumed >= nframes);
            while (av_audio_fifo_size(fifo) >= frame_size
                   || (flush_input && av_audio_fifo_size(fifo) > 0)) {
                const int take = av_audio_fifo_size(fifo) < frame_size
                    ? av_audio_fifo_size(fifo) : frame_size;
                if (av_frame_make_writable(frame) < 0
                        || av_audio_fifo_read(
                               fifo, (void**)frame->data, take) < take) {
                    failed = true;
                    break;
                }
                frame->nb_samples = take;
                frame->pts = pts;
                pts += take;
                if (send_and_mux(frame) != 0) {
                    failed = true;
                    break;
                }
            }
            if (failed)
                break;
        }
        if (failed)
            break;

        // flush swr's internal delay line, then the encoder
        const int tail = swr_convert(
            swr, staging, frame_size, nullptr, 0);
        if (tail > 0) {
            if (av_frame_make_writable(frame) < 0)
                break;
            if (av_samples_copy(
                    frame->data, staging, 0, 0, tail, channels,
                    enc->sample_fmt) < 0)
                break;
            frame->nb_samples = tail;
            frame->pts = pts;
            pts += tail;
            if (send_and_mux(frame) != 0)
                break;
        }
        if (send_and_mux(nullptr) != 0)
            break;
        if (av_write_trailer(fmt) < 0)
            break;
        status = 0;
    } while (false);

    if (status != 0 && header_written)
        av_write_trailer(fmt);  // leave a structurally closed file
    cleanup();
    if (status != 0)
        ::remove(path);
    return status;
}

}  // extern "C"

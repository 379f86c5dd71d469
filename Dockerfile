# motion-estimated-video-trimmer — deployment image for NVIDIA GPU hosts.
#
# FFmpeg 8.0 is built from source (same major as the reference image,
# reference Dockerfile:46-65): distro FFmpeg 5.x exports motion-vector
# side data only for the mpegvideo/h264 decoder families, so an image on
# distro libav would silently degrade HEVC to the pixel-domain SAD
# fallback.  FFmpeg >= 7 exports HEVC MVs and BASELINE config 3 (HEVC 4K
# MV extraction) works natively.  tests/test_codecs.py and the HEVC
# parity scenario gate on io.native.hevc_mv_export_capable(), so running
# the suite inside this image exercises the HEVC MV path end to end.
#
#   docker build -t mvtrim .
#   docker run --gpus 1 \
#     -v /data/input:/input:ro -v /data/output:/output \
#     --env-file config/motion_trim.env mvtrim /input /output
#
# (--gpus needs the NVIDIA container toolkit on the host.)

FROM python:3.12-slim-bookworm AS build

RUN apt-get update && apt-get install -y --no-install-recommends \
        g++ make pkg-config wget xz-utils nasm \
        libx264-dev libx265-dev \
    && rm -rf /var/lib/apt/lists/*

# FFmpeg 8.0 from source: decode-everything + gray-only fast path
# (--enable-gray, same knob the reference relies on) + x264/x265 encoders
# so the synthetic-clip generator (tests, benches, capability probe)
# works inside the image.  Programs/docs are not built — the framework
# links the libraries; the cut is a native libavformat remux.
RUN wget -q https://ffmpeg.org/releases/ffmpeg-8.0.tar.xz -O /tmp/ffmpeg.tar.xz \
    && tar -xJf /tmp/ffmpeg.tar.xz -C /tmp && cd /tmp/ffmpeg-8.0 \
    && ./configure --prefix=/usr/local \
        --enable-gpl --enable-version3 \
        --enable-libx264 --enable-libx265 \
        --enable-gray \
        --enable-shared --enable-pic --disable-static \
        --disable-programs --disable-doc --disable-debug \
    && make -j"$(nproc)" && make install && ldconfig \
    && rm -rf /tmp/ffmpeg*

WORKDIR /app
COPY native/ native/
RUN PKG_CONFIG_PATH=/usr/local/lib/pkgconfig make -C native

FROM python:3.12-slim-bookworm

# runtime deps of the self-built libav* (x264/x265 shared libs) +
# jemalloc, preloaded like the reference image (reference
# Dockerfile:70-77) — long-lived daemons benefit from its arena behavior
RUN apt-get update && apt-get install -y --no-install-recommends \
        libx264-164 libx265-199 libjemalloc2 \
    && rm -rf /var/lib/apt/lists/*
ENV LD_PRELOAD=/usr/lib/x86_64-linux-gnu/libjemalloc.so.2

# the FFmpeg 8.0 libraries built above (HEVC MV export capable)
COPY --from=build /usr/local/lib/libav*.so* /usr/local/lib/
COPY --from=build /usr/local/lib/libsw*.so* /usr/local/lib/
RUN ldconfig

# JAX with its CUDA 12 plugin (pulls the CUDA runtime wheels), at the
# tested version.
RUN pip install --no-cache-dir "jax[cuda12]==0.9.0" numpy

WORKDIR /app
COPY mvtrim_tpu/ mvtrim_tpu/
COPY config/ config/
COPY pyproject.toml README.md ./
COPY --from=build /app/native/libmvtrim_host.so native/libmvtrim_host.so
RUN pip install --no-cache-dir --no-deps .

ENV MVT_NATIVE_LIB=/app/native/libmvtrim_host.so \
    PYTHONUNBUFFERED=1

# fail the build if the image's libav cannot export HEVC MVs — the
# capability this image exists to provide (catches a silent fallback to
# distro libs or a misconfigured FFmpeg build)
RUN python -c "from mvtrim_tpu.io import native; \
    assert native.hevc_mv_export_capable(), \
    'image libavcodec exports no HEVC MV side data'"

ENTRYPOINT ["motion_trim"]

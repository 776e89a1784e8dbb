# Container image for the nyxus_tpu CLI on an NVIDIA GPU (reference:
# Dockerfile:1 ships its CLI in a cuda-runtime image).  JAX's CUDA 12 wheels
# bring the CUDA libraries; the host provides the driver through the NVIDIA
# container toolkit.
#
# Build:  docker build -t nyxus-tpu .
# Run:    docker run --gpus all -v /data:/data nyxus-tpu \
#           --intDir=/data/images/int --segDir=/data/images/seg \
#           --outDir=/data/outputs --features=*ALL*
FROM python:3.12-slim-bookworm

# native toolchain + zlib + libtiff for the C++ runtime components (CSV
# writer, codecs, geometry kernels and the TIFF region server are built on
# first use); libcharls for JPEG-LS DICOM
RUN apt-get update && apt-get install -y --no-install-recommends \
        g++ zlib1g-dev libtiff-dev libcharls2 \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /opt/nyxus_tpu
COPY pyproject.toml setup.py ./
COPY nyxus_tpu ./nyxus_tpu

RUN pip install --no-cache-dir \
        "jax[cuda12]" numpy pandas scipy pillow pyarrow \
    && pip install --no-cache-dir .

RUN mkdir -p /data/images /data/outputs
WORKDIR /data

ENTRYPOINT ["python", "-m", "nyxus_tpu.cli"]

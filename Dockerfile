# Environment pinning for consent_jax — the counterpart of the
# reference's Dockerfile (reference: Dockerfile:1-24, which pins
# ubuntu:16.04 + conda minimap2/fpa + the C++ toolchain).
#
# The image carries the CUDA toolkit (nvcc builds the Hopper aligner
# kernel, consent_jax/ops/cuda, for sm_90a at first use) and JAX with
# its CUDA plugin (the `jax[cuda12]` extra: jaxlib plus the
# jax-cuda12-plugin / jax-cuda12-pjrt wheels, which bring the CUDA
# runtime libraries XLA needs).  The NVIDIA driver comes from the host
# (run with --gpus all).  Also pinned: numpy, the g++ toolchain for
# the native host library (consent_jax/native), and optional minimap2
# (the built-in minimizer overlapper is used when it is absent —
# consent_jax/overlap/minimizer.py).
FROM nvidia/cuda:12.8.1-devel-ubuntu24.04

RUN apt-get update && \
    apt-get install -y --no-install-recommends python3 python3-venv \
        g++ make curl && \
    rm -rf /var/lib/apt/lists/*
RUN python3 -m venv /opt/venv
ENV PATH=/opt/venv/bin:$PATH

# versions mirrored from the development environment
RUN pip install --no-cache-dir \
    "jax[cuda12]==0.9.0" \
    "numpy==2.0.2" \
    pytest

# optional: reference-identical overlapper (the native minimizer
# overlapper is the fallback; CONSENT-correct:185 uses minimap2)
# RUN apt-get install -y minimap2

COPY . /app
WORKDIR /app
RUN pip install --no-cache-dir -e .

# build the native host library once at image build (the ctypes loader
# would otherwise compile it lazily on first use); the GPU kernel needs
# no card to compile: python -m consent_jax.ops.gpu_align
RUN python -c "from consent_jax import native; native.get_lib()" && \
    python -m consent_jax.ops.gpu_align

ENTRYPOINT ["consent-correct"]

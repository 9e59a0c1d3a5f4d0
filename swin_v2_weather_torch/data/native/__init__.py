"""The native ERA5 pread reader (a copy of the JAX package's ``data/native``):
``reader.NativeEra5Reader`` over ``era5_native.cpp``, built with g++ at first
use."""

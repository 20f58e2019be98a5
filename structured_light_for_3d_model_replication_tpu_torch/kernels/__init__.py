"""Build and ``ctypes`` bindings for the hand-written CUDA kernels in
``csrc/``. Imported lazily, by a wrapper about to launch a kernel on a
CUDA tensor — never at package import, so hosts without ``nvcc`` or a card
import the port freely."""

"""Foreign-language bindings (ref: parsec/fortran/ — here the host
runtime is Python, so the foreign side is C: parsec_tpu_c.h + the
libparsec_tpu_c embedding shim, with chelper.py as the marshalling
layer).  The library is built at first use into ``build/bindings/`` at
the root of the checkout (bindings/build.py), never into this
directory."""

"""The port's host-side C++ components: sources in ``native/src/``, built
at first use by ``native/build.py`` and loaded with ctypes."""

"""Native host code: the wire codec (``wire_codec.cpp``, a copy of the JAX
package's ``runtime/wire_codec.cpp``), built with g++ at first use."""

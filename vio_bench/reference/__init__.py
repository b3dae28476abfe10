"""The plain reference of the port's main path: plain torch, any dtype, and
nothing of the port, of JAX or of the JAX package."""

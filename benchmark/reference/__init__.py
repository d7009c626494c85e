"""The plain reference that decides `correct`: NumPy and plain PyTorch,
importing neither `jax`, `pcrhpg24_tpu` nor anything of
`pcrhpg24_tpu_torch`.  It takes the generated points and the camera path
and works out again everything the port's set-up derives from them
(Morton order, BC1 colours, batch boxes and anchors, the 10-10-10
packing, cull, LOD and precision levels), in frozen copies of the
arithmetic whose bits the port's images are held to."""

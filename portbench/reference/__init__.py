"""The plain reference: the same segmentation in plain PyTorch and NumPy.

Nothing here imports the program under test (``digipathai_tpu_torch``),
the JAX package or JAX.  It reads the slide with its own TIFF reader,
plans the patches again, runs its own float32 copies of the models and
adds their maps up as patch mode defines it.
"""

"""The benchmark's plain reference of ddsp_tpu_torch's served and trained
paths: plain PyTorch in float32 (TF32 off) with its own threefry,
written from the published description of each layer.  It imports nothing
of the program, and takes from it nothing but the outputs it judges."""

"""Device ms a step launched inside the program's ``z_encoder`` range (the
autoencoder's forward z: the MFCCs, the norm, the encoder's GRU, the dense
layer and the upsampling)."""


def read(w):
    return w.per_unit_ms("z_encoder") if "z_encoder" in w.device_s else None

"""The spectrogram experiments: style transfer (``style_transfer``, on the
port's optax-equal L-BFGS in ``lbfgs``), CREPE DeepDream (``dream``) and
the Streamlit front end (``ui``); counterparts of
``ddsp_tpu/experiments/``."""

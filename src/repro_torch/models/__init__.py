"""Model code of the port: pure-attention decoders (dense MLP or MoE layers) over
paged pools."""

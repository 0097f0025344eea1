"""Model code of the port: dense pure-attention decoders over paged pools."""

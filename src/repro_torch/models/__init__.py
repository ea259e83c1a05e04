"""The language-model stack of the port: layers, the transformer, the
``Model`` facade and its one-card sharding policy."""

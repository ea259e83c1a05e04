"""The language-model stack of the port: layers, the routed MoE, the Mamba1
and Mamba2 blocks, the transformer, the ``Model`` facade, its sharding
policy and the collectives of a mesh of ranks."""

"""The port's training data: the synthetic LM stream and its submodular
batch curation."""

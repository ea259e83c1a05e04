"""Architecture configs of the language models the port serves (the JAX
package's shapes, kept as the port's own copy)."""

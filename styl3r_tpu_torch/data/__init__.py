"""Host-side data readers of the inference path (counterpart of the parts of
styl3r_tpu/data/ that the inference CLIs use): numpy arrays in the JAX
package's layouts."""

"""The plain reference that decides ``correct``: plain NumPy and PyTorch,
importing nothing of the program (``havac_tpu_torch``) or of the JAX
package."""

"""The port's tools: the X-ray luminosity recalculation
(``xray_calculator.py``), the one tool of the JAX package's with device
work."""

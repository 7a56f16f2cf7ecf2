"""The plain reference that decides ``correct``: frozen copies, in plain
PyTorch, of the modules the port's frame-loop stages call, and the stages
themselves (``stages.py``).  Nothing here imports the program, JAX or the JAX
package; the LK track is the plain version.  ``build.py`` makes the
reference's own configuration, rig and IMU noise from a configuration file.
"""

"""Host-side utilities of the port: checkpoints (and their background
writer), metric logging, image grids, step timing and tracing, op timing on
the device, host-side construction, and the build directory of the
package's compiled libraries."""

"""Work accounting and the roofline of the port (``accounting``,
``roofline``): what the port's own dispatch runs, and the least time the
card could take for it."""

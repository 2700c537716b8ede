"""One driver a traffic kind. A mix file names its kind; the driver of
that name builds the system under test, runs the window and judges it."""

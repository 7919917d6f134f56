"""Runtime helpers: device selection and the step watchdog."""

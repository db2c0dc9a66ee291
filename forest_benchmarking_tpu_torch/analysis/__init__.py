"""Analysis helpers of the port: curve-fit models and the batched
Levenberg-Marquardt fitter (:mod:`.fitting`)."""

"""Lock factory kept at the call sites of the serving code; the JAX
package's concurrency sanitizer is not ported, so this is the stdlib lock."""
import threading


def lock(module, name):
    return threading.Lock()

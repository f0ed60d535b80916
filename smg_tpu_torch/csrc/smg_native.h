/* C ABI of the port's native radix index (radix_index.cpp) — consumed by
 * the ctypes loader smg_tpu_torch/kv_index/native.py; the port's own copy
 * of the repository's csrc/smg_native.h.
 * Reference: the cdylib surface of bindings/golang/src/lib.rs. */
#ifndef SMG_NATIVE_H
#define SMG_NATIVE_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Radix prefix index over token sequences (cache-aware routing). */
void*  rt_new(size_t max_size);
void   rt_free(void* t);
void   rt_insert(void* t, const uint32_t* tokens, size_t n, uint32_t worker);
size_t rt_match(void* t, const uint32_t* tokens, size_t n,
                uint32_t* out_workers, uint32_t* out_lens, size_t cap);
void   rt_remove_worker(void* t, uint32_t worker);
size_t rt_size(void* t);

#ifdef __cplusplus
}
#endif

#endif /* SMG_NATIVE_H */

/* Native runtime core for parsec_tpu_torch.
 *
 * C++ implementations of the hot host-side containers and allocators that
 * the reference implements in C (SURVEY.md §2.1 "Class system"):
 *   - Lifo      : Treiber stack            (ref: parsec/class/lifo.h)
 *   - Fifo      : linked queue             (ref: parsec/class/fifo.h)
 *   - Dequeue   : double-ended queue       (ref: parsec/class/dequeue.h)
 *   - OrderedList : priority-sorted list   (ref: parsec/class/parsec_list.h,
 *                   used by ap/ip/spq schedulers)
 *   - HashTable64 : bucket-locked resizable hash table with 64-bit keys
 *                   (ref: parsec/class/parsec_hash_table.c:1-745)
 *   - ZoneMalloc  : segment-based arena allocator for device-heap
 *                   bookkeeping (ref: parsec/utils/zone_malloc.c)
 *
 * Exposed as the CPython extension module `_parsec_torch_native` (built by
 * parsec_tpu_torch/native/build.py with g++ into build/native/; no
 * pybind11).
 * Containers store PyObject* with ownership transferred on push and
 * returned on pop.  Internal spinlocks keep the structures correct when
 * the GIL is released between bytecodes of concurrent worker threads and
 * keep the design ready for free-threaded builds.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <deque>
#include <map>
#include <mutex>
#include <new>
#include <utility>
#include <vector>

namespace {

/* ------------------------------------------------------------------ */
/* small spinlock (containers are held only for pointer swaps)        */
/* ------------------------------------------------------------------ */
class SpinLock {
  std::atomic_flag f_ = ATOMIC_FLAG_INIT;
 public:
  void lock() noexcept {
    while (f_.test_and_set(std::memory_order_acquire)) {
#if defined(__x86_64__)
      __builtin_ia32_pause();
#endif
    }
  }
  void unlock() noexcept { f_.clear(std::memory_order_release); }
};
using SpinGuard = std::lock_guard<SpinLock>;

/* ================================================================== */
/* Lifo                                                               */
/* ================================================================== */
struct LifoNode {
  PyObject* item;
  LifoNode* next;
};

struct LifoObject {
  PyObject_HEAD
  std::atomic<LifoNode*> head;
  std::atomic<Py_ssize_t> count;
};

static PyObject* Lifo_new(PyTypeObject* type, PyObject*, PyObject*) {
  LifoObject* self = (LifoObject*)type->tp_alloc(type, 0);
  if (self) {
    new (&self->head) std::atomic<LifoNode*>(nullptr);
    new (&self->count) std::atomic<Py_ssize_t>(0);
  }
  return (PyObject*)self;
}

static void lifo_push_node(LifoObject* self, LifoNode* n) {
  LifoNode* old = self->head.load(std::memory_order_relaxed);
  do {
    n->next = old;
  } while (!self->head.compare_exchange_weak(old, n, std::memory_order_release,
                                             std::memory_order_relaxed));
  self->count.fetch_add(1, std::memory_order_relaxed);
}

static PyObject* Lifo_push(LifoObject* self, PyObject* item) {
  LifoNode* n = new LifoNode{item, nullptr};
  Py_INCREF(item);
  lifo_push_node(self, n);
  Py_RETURN_NONE;
}

static PyObject* Lifo_push_chain(LifoObject* self, PyObject* iterable) {
  PyObject* it = PyObject_GetIter(iterable);
  if (!it) return nullptr;
  PyObject* item;
  while ((item = PyIter_Next(it)) != nullptr) {
    lifo_push_node(self, new LifoNode{item, nullptr}); /* steals ref */
  }
  Py_DECREF(it);
  if (PyErr_Occurred()) return nullptr;
  Py_RETURN_NONE;
}

static PyObject* Lifo_pop(LifoObject* self, PyObject*) {
  /* CAS pop; ABA is prevented because nodes are only freed here while the
   * GIL serializes Python-level callers of this function. */
  LifoNode* old = self->head.load(std::memory_order_acquire);
  while (old != nullptr &&
         !self->head.compare_exchange_weak(old, old->next,
                                           std::memory_order_acquire,
                                           std::memory_order_acquire)) {
  }
  if (old == nullptr) Py_RETURN_NONE;
  self->count.fetch_sub(1, std::memory_order_relaxed);
  PyObject* item = old->item; /* ownership transferred to caller */
  delete old;
  return item;
}

static PyObject* Lifo_is_empty(LifoObject* self, PyObject*) {
  return PyBool_FromLong(self->head.load(std::memory_order_acquire) == nullptr);
}

static Py_ssize_t Lifo_len(PyObject* o) {
  return ((LifoObject*)o)->count.load(std::memory_order_relaxed);
}

static void Lifo_dealloc(LifoObject* self) {
  LifoNode* n = self->head.load(std::memory_order_relaxed);
  while (n) {
    LifoNode* nx = n->next;
    Py_DECREF(n->item);
    delete n;
    n = nx;
  }
  Py_TYPE(self)->tp_free((PyObject*)self);
}

static PyMethodDef Lifo_methods[] = {
    {"push", (PyCFunction)Lifo_push, METH_O, "Push one item."},
    {"push_chain", (PyCFunction)Lifo_push_chain, METH_O, "Push an iterable."},
    {"pop", (PyCFunction)Lifo_pop, METH_NOARGS, "Pop newest or None."},
    {"try_pop", (PyCFunction)Lifo_pop, METH_NOARGS, "Alias of pop."},
    {"is_empty", (PyCFunction)Lifo_is_empty, METH_NOARGS, ""},
    {nullptr, nullptr, 0, nullptr}};

static PySequenceMethods Lifo_as_seq = {Lifo_len};

static PyTypeObject LifoType = []{
  PyTypeObject t = {PyVarObject_HEAD_INIT(nullptr, 0)};
  t.tp_name = "_parsec_torch_native.Lifo";
  t.tp_basicsize = sizeof(LifoObject);
  t.tp_flags = Py_TPFLAGS_DEFAULT;
  t.tp_doc = "Lock-free LIFO (Treiber stack).";
  t.tp_new = Lifo_new;
  t.tp_dealloc = (destructor)Lifo_dealloc;
  t.tp_methods = Lifo_methods;
  t.tp_as_sequence = &Lifo_as_seq;
  return t;
}();

/* ================================================================== */
/* Fifo / Dequeue share a spinlocked std::deque core                   */
/* ================================================================== */
struct DequeObject {
  PyObject_HEAD
  SpinLock* lock;
  std::deque<PyObject*>* d;
};

static PyObject* Deque_new(PyTypeObject* type, PyObject*, PyObject*) {
  DequeObject* self = (DequeObject*)type->tp_alloc(type, 0);
  if (self) {
    self->lock = new SpinLock();
    self->d = new std::deque<PyObject*>();
  }
  return (PyObject*)self;
}

static void Deque_dealloc(DequeObject* self) {
  for (PyObject* o : *self->d) Py_DECREF(o);
  delete self->d;
  delete self->lock;
  Py_TYPE(self)->tp_free((PyObject*)self);
}

static PyObject* Deque_push_back(DequeObject* self, PyObject* item) {
  Py_INCREF(item);
  { SpinGuard g(*self->lock); self->d->push_back(item); }
  Py_RETURN_NONE;
}

static PyObject* Deque_push_front(DequeObject* self, PyObject* item) {
  Py_INCREF(item);
  { SpinGuard g(*self->lock); self->d->push_front(item); }
  Py_RETURN_NONE;
}

static int collect_iterable(PyObject* iterable, std::vector<PyObject*>& out) {
  PyObject* it = PyObject_GetIter(iterable);
  if (!it) return -1;
  PyObject* item;
  while ((item = PyIter_Next(it)) != nullptr) out.push_back(item);
  Py_DECREF(it);
  return PyErr_Occurred() ? -1 : 0;
}

static PyObject* Deque_push_back_chain(DequeObject* self, PyObject* iterable) {
  std::vector<PyObject*> items;
  if (collect_iterable(iterable, items) < 0) return nullptr;
  { SpinGuard g(*self->lock);
    for (PyObject* o : items) self->d->push_back(o); }
  Py_RETURN_NONE;
}

static PyObject* Deque_push_front_chain(DequeObject* self, PyObject* iterable) {
  std::vector<PyObject*> items;
  if (collect_iterable(iterable, items) < 0) return nullptr;
  { SpinGuard g(*self->lock);
    for (auto r = items.rbegin(); r != items.rend(); ++r)
      self->d->push_front(*r); }
  Py_RETURN_NONE;
}

static PyObject* Deque_pop_front(DequeObject* self, PyObject*) {
  PyObject* item = nullptr;
  { SpinGuard g(*self->lock);
    if (!self->d->empty()) { item = self->d->front(); self->d->pop_front(); } }
  if (!item) Py_RETURN_NONE;
  return item;
}

static PyObject* Deque_pop_back(DequeObject* self, PyObject*) {
  PyObject* item = nullptr;
  { SpinGuard g(*self->lock);
    if (!self->d->empty()) { item = self->d->back(); self->d->pop_back(); } }
  if (!item) Py_RETURN_NONE;
  return item;
}

static PyObject* Deque_is_empty(DequeObject* self, PyObject*) {
  SpinGuard g(*self->lock);
  return PyBool_FromLong(self->d->empty());
}

static Py_ssize_t Deque_len(PyObject* o) {
  DequeObject* self = (DequeObject*)o;
  SpinGuard g(*self->lock);
  return (Py_ssize_t)self->d->size();
}

static PyMethodDef Dequeue_methods[] = {
    {"push_front", (PyCFunction)Deque_push_front, METH_O, ""},
    {"push_back", (PyCFunction)Deque_push_back, METH_O, ""},
    {"push_front_chain", (PyCFunction)Deque_push_front_chain, METH_O, ""},
    {"push_back_chain", (PyCFunction)Deque_push_back_chain, METH_O, ""},
    {"pop_front", (PyCFunction)Deque_pop_front, METH_NOARGS, ""},
    {"pop_back", (PyCFunction)Deque_pop_back, METH_NOARGS, ""},
    {"is_empty", (PyCFunction)Deque_is_empty, METH_NOARGS, ""},
    {nullptr, nullptr, 0, nullptr}};

static PySequenceMethods Deque_as_seq = {Deque_len};

static PyTypeObject DequeueType = []{
  PyTypeObject t = {PyVarObject_HEAD_INIT(nullptr, 0)};
  t.tp_name = "_parsec_torch_native.Dequeue";
  t.tp_basicsize = sizeof(DequeObject);
  t.tp_flags = Py_TPFLAGS_DEFAULT;
  t.tp_doc = "Double-ended queue (spinlocked).";
  t.tp_new = Deque_new;
  t.tp_dealloc = (destructor)Deque_dealloc;
  t.tp_methods = Dequeue_methods;
  t.tp_as_sequence = &Deque_as_seq;
  return t;
}();

/* Fifo: the same core, restricted API (push == push_back, pop == front). */
static PyMethodDef Fifo_methods[] = {
    {"push", (PyCFunction)Deque_push_back, METH_O, ""},
    {"push_chain", (PyCFunction)Deque_push_back_chain, METH_O, ""},
    {"pop", (PyCFunction)Deque_pop_front, METH_NOARGS, ""},
    {"is_empty", (PyCFunction)Deque_is_empty, METH_NOARGS, ""},
    {nullptr, nullptr, 0, nullptr}};

static PyTypeObject FifoType = []{
  PyTypeObject t = {PyVarObject_HEAD_INIT(nullptr, 0)};
  t.tp_name = "_parsec_torch_native.Fifo";
  t.tp_basicsize = sizeof(DequeObject);
  t.tp_flags = Py_TPFLAGS_DEFAULT;
  t.tp_doc = "FIFO queue (spinlocked).";
  t.tp_new = Deque_new;
  t.tp_dealloc = (destructor)Deque_dealloc;
  t.tp_methods = Fifo_methods;
  t.tp_as_sequence = &Deque_as_seq;
  return t;
}();

/* ================================================================== */
/* OrderedList: priority-sorted with FIFO tie-break                    */
/* ================================================================== */
struct OrderedObject {
  PyObject_HEAD
  SpinLock* lock;
  /* key = (-priority, seq) so begin() is highest priority, oldest first */
  std::map<std::pair<int64_t, uint64_t>, PyObject*>* m;
  uint64_t seq;
};

static PyObject* Ordered_new(PyTypeObject* type, PyObject*, PyObject*) {
  OrderedObject* self = (OrderedObject*)type->tp_alloc(type, 0);
  if (self) {
    self->lock = new SpinLock();
    self->m = new std::map<std::pair<int64_t, uint64_t>, PyObject*>();
    self->seq = 0;
  }
  return (PyObject*)self;
}

static void Ordered_dealloc(OrderedObject* self) {
  for (auto& kv : *self->m) Py_DECREF(kv.second);
  delete self->m;
  delete self->lock;
  Py_TYPE(self)->tp_free((PyObject*)self);
}

static PyObject* Ordered_push_sorted(OrderedObject* self, PyObject* args) {
  PyObject* item;
  long long prio = 0;
  if (!PyArg_ParseTuple(args, "O|L", &item, &prio)) return nullptr;
  Py_INCREF(item);
  { SpinGuard g(*self->lock);
    self->m->emplace(std::make_pair(-(int64_t)prio, self->seq++), item); }
  Py_RETURN_NONE;
}

static PyObject* Ordered_push_sorted_chain(OrderedObject* self, PyObject* args) {
  PyObject *iterable, *prio_fn;
  if (!PyArg_ParseTuple(args, "OO", &iterable, &prio_fn)) return nullptr;
  PyObject* it = PyObject_GetIter(iterable);
  if (!it) return nullptr;
  PyObject* item;
  while ((item = PyIter_Next(it)) != nullptr) {
    PyObject* pr = PyObject_CallFunctionObjArgs(prio_fn, item, nullptr);
    if (!pr) { Py_DECREF(item); Py_DECREF(it); return nullptr; }
    long long prio = PyLong_AsLongLong(pr);
    Py_DECREF(pr);
    if (prio == -1 && PyErr_Occurred()) { Py_DECREF(item); Py_DECREF(it); return nullptr; }
    { SpinGuard g(*self->lock);
      self->m->emplace(std::make_pair(-(int64_t)prio, self->seq++), item); }
  }
  Py_DECREF(it);
  if (PyErr_Occurred()) return nullptr;
  Py_RETURN_NONE;
}

static PyObject* Ordered_pop_front(OrderedObject* self, PyObject*) {
  PyObject* item = nullptr;
  { SpinGuard g(*self->lock);
    auto b = self->m->begin();
    if (b != self->m->end()) { item = b->second; self->m->erase(b); } }
  if (!item) Py_RETURN_NONE;
  return item;
}

static PyObject* Ordered_pop_back(OrderedObject* self, PyObject*) {
  PyObject* item = nullptr;
  { SpinGuard g(*self->lock);
    if (!self->m->empty()) {
      auto e = std::prev(self->m->end());
      item = e->second;
      self->m->erase(e);
    } }
  if (!item) Py_RETURN_NONE;
  return item;
}

static PyObject* Ordered_is_empty(OrderedObject* self, PyObject*) {
  SpinGuard g(*self->lock);
  return PyBool_FromLong(self->m->empty());
}

static Py_ssize_t Ordered_len(PyObject* o) {
  OrderedObject* self = (OrderedObject*)o;
  SpinGuard g(*self->lock);
  return (Py_ssize_t)self->m->size();
}

static PyMethodDef Ordered_methods[] = {
    {"push_sorted", (PyCFunction)Ordered_push_sorted, METH_VARARGS, ""},
    {"push_sorted_chain", (PyCFunction)Ordered_push_sorted_chain, METH_VARARGS, ""},
    {"pop_front", (PyCFunction)Ordered_pop_front, METH_NOARGS, ""},
    {"pop_back", (PyCFunction)Ordered_pop_back, METH_NOARGS, ""},
    {"is_empty", (PyCFunction)Ordered_is_empty, METH_NOARGS, ""},
    {nullptr, nullptr, 0, nullptr}};

static PySequenceMethods Ordered_as_seq = {Ordered_len};

static PyTypeObject OrderedType = []{
  PyTypeObject t = {PyVarObject_HEAD_INIT(nullptr, 0)};
  t.tp_name = "_parsec_torch_native.OrderedList";
  t.tp_basicsize = sizeof(OrderedObject);
  t.tp_flags = Py_TPFLAGS_DEFAULT;
  t.tp_doc = "Priority-sorted list, FIFO within equal priority.";
  t.tp_new = Ordered_new;
  t.tp_dealloc = (destructor)Ordered_dealloc;
  t.tp_methods = Ordered_methods;
  t.tp_as_sequence = &Ordered_as_seq;
  return t;
}();

/* ================================================================== */
/* HashTable64: bucket-locked, resizable, 64-bit keys                  */
/* ================================================================== */
struct HT64Entry {
  uint64_t key;
  PyObject* value;
  HT64Entry* next;
};

struct HT64Object {
  PyObject_HEAD
  std::vector<HT64Entry*>* buckets;
  std::vector<SpinLock>* locks; /* stripes, fixed count */
  std::atomic<Py_ssize_t> count;
  SpinLock* resize_lock;
};

static const size_t HT64_NSTRIPES = 64;

static inline uint64_t ht64_mix(uint64_t k) {
  /* splitmix64 finalizer */
  k += 0x9e3779b97f4a7c15ULL;
  k = (k ^ (k >> 30)) * 0xbf58476d1ce4e5b9ULL;
  k = (k ^ (k >> 27)) * 0x94d049bb133111ebULL;
  return k ^ (k >> 31);
}

static PyObject* HT64_new(PyTypeObject* type, PyObject*, PyObject*) {
  HT64Object* self = (HT64Object*)type->tp_alloc(type, 0);
  if (self) {
    self->buckets = new std::vector<HT64Entry*>(256, nullptr);
    self->locks = new std::vector<SpinLock>(HT64_NSTRIPES);
    new (&self->count) std::atomic<Py_ssize_t>(0);
    self->resize_lock = new SpinLock();
  }
  return (PyObject*)self;
}

static void HT64_dealloc(HT64Object* self) {
  for (HT64Entry* e : *self->buckets) {
    while (e) {
      HT64Entry* nx = e->next;
      Py_DECREF(e->value);
      delete e;
      e = nx;
    }
  }
  delete self->buckets;
  delete self->locks;
  delete self->resize_lock;
  Py_TYPE(self)->tp_free((PyObject*)self);
}

static void ht64_maybe_resize(HT64Object* self) {
  size_t nb = self->buckets->size();
  if ((size_t)self->count.load(std::memory_order_relaxed) < nb * 2) return;
  /* take all stripe locks in order, then rehash (ref resizes under a
   * global section the same way: parsec_hash_table.c) */
  SpinGuard rg(*self->resize_lock);
  nb = self->buckets->size();
  if ((size_t)self->count.load(std::memory_order_relaxed) < nb * 2) return;
  for (auto& l : *self->locks) l.lock();
  auto* nb_v = new std::vector<HT64Entry*>(nb * 4, nullptr);
  for (HT64Entry* e : *self->buckets) {
    while (e) {
      HT64Entry* nx = e->next;
      size_t idx = ht64_mix(e->key) & (nb_v->size() - 1);
      e->next = (*nb_v)[idx];
      (*nb_v)[idx] = e;
      e = nx;
    }
  }
  delete self->buckets;
  self->buckets = nb_v;
  for (auto& l : *self->locks) l.unlock();
}

struct HT64Locked {
  HT64Object* self;
  size_t stripe;
  HT64Locked(HT64Object* s, uint64_t h) : self(s), stripe(h % HT64_NSTRIPES) {
    (*self->locks)[stripe].lock();
  }
  ~HT64Locked() { (*self->locks)[stripe].unlock(); }
};

/* key conversion: accept anything the 'K' format accepts (wraps negative
 * ints mod 2^64) so insert/find/remove are symmetric */
static int ht64_key(PyObject* arg, uint64_t* out) {
  unsigned long long k = PyLong_AsUnsignedLongLongMask(arg);
  if (k == (unsigned long long)-1 && PyErr_Occurred()) return -1;
  *out = k;
  return 0;
}

static PyObject* HT64_insert(HT64Object* self, PyObject* args) {
  unsigned long long key;
  PyObject* value;
  if (!PyArg_ParseTuple(args, "KO", &key, &value)) return nullptr;
  uint64_t h = ht64_mix(key);
  PyObject* replaced = nullptr;
  {
    HT64Locked g(self, h);
    size_t idx = h & (self->buckets->size() - 1);
    HT64Entry* found = nullptr;
    for (HT64Entry* e = (*self->buckets)[idx]; e; e = e->next) {
      if (e->key == key) { found = e; break; }
    }
    if (found) {
      Py_INCREF(value);
      replaced = found->value; /* DECREF outside the stripe lock: it may
                                * run __del__ / GC, which can re-enter
                                * this table on the same stripe */
      found->value = value;
    } else {
      Py_INCREF(value);
      (*self->buckets)[idx] = new HT64Entry{key, value, (*self->buckets)[idx]};
      self->count.fetch_add(1, std::memory_order_relaxed);
    }
  }
  Py_XDECREF(replaced);
  ht64_maybe_resize(self);
  Py_RETURN_NONE;
}

static PyObject* HT64_find(HT64Object* self, PyObject* arg) {
  uint64_t key;
  if (ht64_key(arg, &key) < 0) return nullptr;
  uint64_t h = ht64_mix(key);
  HT64Locked g(self, h);
  size_t idx = h & (self->buckets->size() - 1);
  for (HT64Entry* e = (*self->buckets)[idx]; e; e = e->next) {
    if (e->key == key) {
      Py_INCREF(e->value);
      return e->value;
    }
  }
  Py_RETURN_NONE;
}

static PyObject* HT64_remove(HT64Object* self, PyObject* arg) {
  uint64_t key;
  if (ht64_key(arg, &key) < 0) return nullptr;
  uint64_t h = ht64_mix(key);
  HT64Locked g(self, h);
  size_t idx = h & (self->buckets->size() - 1);
  HT64Entry** pe = &(*self->buckets)[idx];
  while (*pe) {
    if ((*pe)->key == key) {
      HT64Entry* e = *pe;
      *pe = e->next;
      self->count.fetch_sub(1, std::memory_order_relaxed);
      PyObject* v = e->value; /* transfer */
      delete e;
      return v;
    }
    pe = &(*pe)->next;
  }
  Py_RETURN_NONE;
}

static PyObject* HT64_find_or_insert(HT64Object* self, PyObject* args) {
  unsigned long long key;
  PyObject* factory;
  if (!PyArg_ParseTuple(args, "KO", &key, &factory)) return nullptr;
  uint64_t h = ht64_mix(key);
  {
    HT64Locked g(self, h);
    size_t idx = h & (self->buckets->size() - 1);
    for (HT64Entry* e = (*self->buckets)[idx]; e; e = e->next) {
      if (e->key == key) {
        PyObject* r = PyTuple_New(2);
        Py_INCREF(e->value);
        PyTuple_SET_ITEM(r, 0, e->value);
        Py_INCREF(Py_False);
        PyTuple_SET_ITEM(r, 1, Py_False);
        return r;
      }
    }
  }
  /* call the factory OUTSIDE the stripe lock: it may run arbitrary Python
   * (incl. re-entering this table); then retry-insert */
  PyObject* v = PyObject_CallNoArgs(factory);
  if (!v) return nullptr;
  {
    HT64Locked g(self, h);
    size_t idx = h & (self->buckets->size() - 1);
    for (HT64Entry* e = (*self->buckets)[idx]; e; e = e->next) {
      if (e->key == key) { /* lost the race */
        PyObject* r = PyTuple_New(2);
        Py_INCREF(e->value);
        PyTuple_SET_ITEM(r, 0, e->value);
        Py_INCREF(Py_False);
        PyTuple_SET_ITEM(r, 1, Py_False);
        Py_DECREF(v);
        return r;
      }
    }
    Py_INCREF(v);
    (*self->buckets)[idx] = new HT64Entry{key, v, (*self->buckets)[idx]};
    self->count.fetch_add(1, std::memory_order_relaxed);
  }
  ht64_maybe_resize(self);
  PyObject* r = PyTuple_New(2);
  PyTuple_SET_ITEM(r, 0, v);
  Py_INCREF(Py_True);
  PyTuple_SET_ITEM(r, 1, Py_True);
  return r;
}

static PyObject* HT64_keys(HT64Object* self, PyObject*) {
  PyObject* lst = PyList_New(0);
  if (!lst) return nullptr;
  for (size_t s = 0; s < HT64_NSTRIPES; ++s) (*self->locks)[s].lock();
  for (HT64Entry* e : *self->buckets) {
    for (; e; e = e->next) {
      PyObject* k = PyLong_FromUnsignedLongLong(e->key);
      PyList_Append(lst, k);
      Py_DECREF(k);
    }
  }
  for (size_t s = 0; s < HT64_NSTRIPES; ++s) (*self->locks)[s].unlock();
  return lst;
}

static Py_ssize_t HT64_len(PyObject* o) {
  return ((HT64Object*)o)->count.load(std::memory_order_relaxed);
}

static PyMethodDef HT64_methods[] = {
    {"insert", (PyCFunction)HT64_insert, METH_VARARGS, "insert(key, value)"},
    {"find", (PyCFunction)HT64_find, METH_O, "find(key) -> value|None"},
    {"remove", (PyCFunction)HT64_remove, METH_O, "remove(key) -> value|None"},
    {"find_or_insert", (PyCFunction)HT64_find_or_insert, METH_VARARGS,
     "find_or_insert(key, factory) -> (value, inserted)"},
    {"keys", (PyCFunction)HT64_keys, METH_NOARGS, ""},
    {nullptr, nullptr, 0, nullptr}};

static PySequenceMethods HT64_as_seq = {HT64_len};

static PyTypeObject HT64Type = []{
  PyTypeObject t = {PyVarObject_HEAD_INIT(nullptr, 0)};
  t.tp_name = "_parsec_torch_native.HashTable64";
  t.tp_basicsize = sizeof(HT64Object);
  t.tp_flags = Py_TPFLAGS_DEFAULT;
  t.tp_doc = "Bucket-locked resizable hash table, uint64 keys.";
  t.tp_new = HT64_new;
  t.tp_dealloc = (destructor)HT64_dealloc;
  t.tp_methods = HT64_methods;
  t.tp_as_sequence = &HT64_as_seq;
  return t;
}();

/* ================================================================== */
/* ZoneMalloc: segment/offset arena allocator                          */
/* ================================================================== */
struct ZoneSeg {
  int64_t off;
  int64_t size;
  bool free_;
};

struct ZoneObject {
  PyObject_HEAD
  SpinLock* lock;
  /* ordered by offset; adjacent free segments are coalesced */
  std::map<int64_t, ZoneSeg>* segs;
  int64_t total;
  int64_t align;
  int64_t used;
};

static PyObject* Zone_new(PyTypeObject* type, PyObject* args, PyObject* kwds) {
  long long total = 0, align = 512;
  static const char* kwlist[] = {"total", "align", nullptr};
  if (!PyArg_ParseTupleAndKeywords(args, kwds, "L|L", (char**)kwlist, &total,
                                   &align))
    return nullptr;
  if (total <= 0 || align <= 0 || (align & (align - 1)) != 0) {
    PyErr_SetString(PyExc_ValueError,
                    "total must be > 0, align a positive power of two");
    return nullptr;
  }
  ZoneObject* self = (ZoneObject*)type->tp_alloc(type, 0);
  if (self) {
    self->lock = new SpinLock();
    self->segs = new std::map<int64_t, ZoneSeg>();
    self->total = total;
    self->align = align;
    self->used = 0;
    self->segs->emplace(0, ZoneSeg{0, total, true});
  }
  return (PyObject*)self;
}

static void Zone_dealloc(ZoneObject* self) {
  delete self->segs;
  delete self->lock;
  Py_TYPE(self)->tp_free((PyObject*)self);
}

static PyObject* Zone_malloc(ZoneObject* self, PyObject* arg) {
  long long nbytes = PyLong_AsLongLong(arg);
  if (nbytes <= 0) {
    if (!PyErr_Occurred())
      PyErr_SetString(PyExc_ValueError, "nbytes must be > 0");
    return nullptr;
  }
  int64_t want = (nbytes + self->align - 1) & ~(self->align - 1);
  SpinGuard g(*self->lock);
  for (auto it = self->segs->begin(); it != self->segs->end(); ++it) {
    ZoneSeg& s = it->second;
    if (!s.free_ || s.size < want) continue;
    if (s.size > want) {
      /* split: tail remains free */
      self->segs->emplace(s.off + want, ZoneSeg{s.off + want, s.size - want, true});
      s.size = want;
    }
    s.free_ = false;
    self->used += want;
    return PyLong_FromLongLong(s.off);
  }
  return PyLong_FromLongLong(-1); /* out of memory: caller evicts (LRU) */
}

static PyObject* Zone_free(ZoneObject* self, PyObject* arg) {
  long long off = PyLong_AsLongLong(arg);
  if (off == -1 && PyErr_Occurred()) return nullptr;
  SpinGuard g(*self->lock);
  auto it = self->segs->find(off);
  if (it == self->segs->end() || it->second.free_) {
    PyErr_SetString(PyExc_ValueError, "invalid or double free");
    return nullptr;
  }
  it->second.free_ = true;
  self->used -= it->second.size;
  /* coalesce with next */
  auto nx = std::next(it);
  if (nx != self->segs->end() && nx->second.free_) {
    it->second.size += nx->second.size;
    self->segs->erase(nx);
  }
  /* coalesce with prev */
  if (it != self->segs->begin()) {
    auto pv = std::prev(it);
    if (pv->second.free_) {
      pv->second.size += it->second.size;
      self->segs->erase(it);
    }
  }
  Py_RETURN_NONE;
}

static PyObject* Zone_used(ZoneObject* self, PyObject*) {
  SpinGuard g(*self->lock);
  return PyLong_FromLongLong(self->used);
}

static PyObject* Zone_available(ZoneObject* self, PyObject*) {
  SpinGuard g(*self->lock);
  return PyLong_FromLongLong(self->total - self->used);
}

static PyObject* Zone_largest_free(ZoneObject* self, PyObject*) {
  SpinGuard g(*self->lock);
  int64_t best = 0;
  for (auto& kv : *self->segs)
    if (kv.second.free_ && kv.second.size > best) best = kv.second.size;
  return PyLong_FromLongLong(best);
}

static PyMethodDef Zone_methods[] = {
    {"malloc", (PyCFunction)Zone_malloc, METH_O,
     "malloc(nbytes) -> offset | -1 when full"},
    {"free", (PyCFunction)Zone_free, METH_O, "free(offset)"},
    {"used", (PyCFunction)Zone_used, METH_NOARGS, ""},
    {"available", (PyCFunction)Zone_available, METH_NOARGS, ""},
    {"largest_free", (PyCFunction)Zone_largest_free, METH_NOARGS, ""},
    {nullptr, nullptr, 0, nullptr}};

static PyTypeObject ZoneType = []{
  PyTypeObject t = {PyVarObject_HEAD_INIT(nullptr, 0)};
  t.tp_name = "_parsec_torch_native.ZoneMalloc";
  t.tp_basicsize = sizeof(ZoneObject);
  t.tp_flags = Py_TPFLAGS_DEFAULT;
  t.tp_doc = "Segment-based arena allocator (offset bookkeeping).";
  t.tp_new = Zone_new;
  t.tp_dealloc = (destructor)Zone_dealloc;
  t.tp_methods = Zone_methods;
  return t;
}();

/* ================================================================== */
/* HBBuffer: bounded per-thread priority buffer with spill             */
/* (ref: parsec/hbbuffer.c:1-277 — the local-queue schedulers' hot     */
/*  structure; overflow spills to a parent push fn)                    */
/* ================================================================== */
struct HBItem {
  int64_t prio;
  uint64_t seq;
  PyObject* item;
};

/* max-heap: highest priority first, FIFO (lowest seq) within a priority */
static inline bool hb_less(const HBItem& a, const HBItem& b) {
  return a.prio < b.prio || (a.prio == b.prio && a.seq > b.seq);
}

struct HBBufferObject {
  PyObject_HEAD
  SpinLock* lock;
  std::vector<HBItem>* heap;
  PyObject* parent_push;  /* callable(list, distance) */
  PyObject* prio_fn;      /* callable(item) -> int, or NULL */
  Py_ssize_t cap;
  uint64_t seq;
};

static int hb_prio_of(HBBufferObject* self, PyObject* item, int64_t* out) {
  if (self->prio_fn != nullptr && self->prio_fn != Py_None) {
    PyObject* pr = PyObject_CallFunctionObjArgs(self->prio_fn, item, nullptr);
    if (!pr) return -1;
    *out = (int64_t)PyLong_AsLongLong(pr);
    Py_DECREF(pr);
    if (*out == -1 && PyErr_Occurred()) return -1;
    return 0;
  }
  PyObject* pr = PyObject_GetAttrString(item, "priority");
  if (!pr) { PyErr_Clear(); *out = 0; return 0; }
  *out = (int64_t)PyLong_AsLongLong(pr);
  Py_DECREF(pr);
  if (*out == -1 && PyErr_Occurred()) { PyErr_Clear(); *out = 0; }
  return 0;
}

static PyObject* HBBuffer_new(PyTypeObject* type, PyObject*, PyObject*) {
  HBBufferObject* self = (HBBufferObject*)type->tp_alloc(type, 0);
  if (self) {
    self->lock = new SpinLock();
    self->heap = new std::vector<HBItem>();
    self->parent_push = nullptr;
    self->prio_fn = nullptr;
    self->cap = 0;
    self->seq = 0;
  }
  return (PyObject*)self;
}

static int HBBuffer_init(PyObject* o, PyObject* args, PyObject* kwds) {
  HBBufferObject* self = (HBBufferObject*)o;
  static const char* kwlist[] = {"size", "parent_push", "prio_fn", nullptr};
  Py_ssize_t size = 0;
  PyObject *parent = nullptr, *prio_fn = nullptr;
  if (!PyArg_ParseTupleAndKeywords(args, kwds, "nO|O", (char**)kwlist,
                                   &size, &parent, &prio_fn))
    return -1;
  if (size <= 0) {
    PyErr_SetString(PyExc_ValueError, "HBBuffer size must be > 0");
    return -1;
  }
  self->cap = size;
  Py_INCREF(parent);
  Py_XSETREF(self->parent_push, parent);
  Py_XINCREF(prio_fn);
  Py_XSETREF(self->prio_fn, prio_fn);
  return 0;
}

static void HBBuffer_dealloc(HBBufferObject* self) {
  for (auto& e : *self->heap) Py_DECREF(e.item);
  delete self->heap;
  delete self->lock;
  Py_XDECREF(self->parent_push);
  Py_XDECREF(self->prio_fn);
  Py_TYPE(self)->tp_free((PyObject*)self);
}

static PyObject* HBBuffer_push_all(HBBufferObject* self, PyObject* args) {
  PyObject* iterable;
  long long distance = 0;
  if (!PyArg_ParseTuple(args, "O|L", &iterable, &distance)) return nullptr;
  PyObject* it = PyObject_GetIter(iterable);
  if (!it) return nullptr;
  PyObject* spill = PyList_New(0);
  if (!spill) { Py_DECREF(it); return nullptr; }
  PyObject* item;
  int failed = 0;
  while (!failed && (item = PyIter_Next(it)) != nullptr) {
    int64_t prio = 0;
    if (hb_prio_of(self, item, &prio) < 0) { Py_DECREF(item); failed = 1; break; }
    PyObject* displaced = nullptr;
    { SpinGuard g(*self->lock);
      if ((Py_ssize_t)self->heap->size() < self->cap) {
        self->heap->push_back({prio, self->seq++, item});
        std::push_heap(self->heap->begin(), self->heap->end(), hb_less);
        item = nullptr;
      } else {
        /* find the worst element: lowest priority, newest within ties
         * (matches the Python fallback's max() over (-prio, seq)) */
        size_t worst = 0;
        for (size_t i = 1; i < self->heap->size(); i++) {
          const HBItem &a = (*self->heap)[i], &b = (*self->heap)[worst];
          if (a.prio < b.prio || (a.prio == b.prio && a.seq > b.seq))
            worst = i;
        }
        if (prio > (*self->heap)[worst].prio) {
          displaced = (*self->heap)[worst].item;
          (*self->heap)[worst] = {prio, self->seq++, item};
          std::make_heap(self->heap->begin(), self->heap->end(), hb_less);
          item = nullptr;
        }
      } }
    PyObject* to_spill = item != nullptr ? item : displaced;
    if (to_spill != nullptr) {
      if (PyList_Append(spill, to_spill) < 0) failed = 1;
      Py_DECREF(to_spill);
    }
  }
  Py_DECREF(it);
  if (failed || PyErr_Occurred()) { Py_DECREF(spill); return nullptr; }
  if (PyList_GET_SIZE(spill) > 0) {
    PyObject* r = PyObject_CallFunction(self->parent_push, "OL", spill,
                                        distance + 1);
    if (!r) { Py_DECREF(spill); return nullptr; }
    Py_DECREF(r);
  }
  Py_DECREF(spill);
  Py_RETURN_NONE;
}

static PyObject* HBBuffer_pop_best(HBBufferObject* self, PyObject*) {
  PyObject* item = nullptr;
  { SpinGuard g(*self->lock);
    if (!self->heap->empty()) {
      std::pop_heap(self->heap->begin(), self->heap->end(), hb_less);
      item = self->heap->back().item;
      self->heap->pop_back();
    } }
  if (!item) Py_RETURN_NONE;
  return item;
}

static PyObject* HBBuffer_is_empty(HBBufferObject* self, PyObject*) {
  SpinGuard g(*self->lock);
  return PyBool_FromLong(self->heap->empty());
}

static Py_ssize_t HBBuffer_len(PyObject* o) {
  HBBufferObject* self = (HBBufferObject*)o;
  SpinGuard g(*self->lock);
  return (Py_ssize_t)self->heap->size();
}

static PyMethodDef HBBuffer_methods[] = {
    {"push_all", (PyCFunction)HBBuffer_push_all, METH_VARARGS, ""},
    {"pop_best", (PyCFunction)HBBuffer_pop_best, METH_NOARGS, ""},
    {"is_empty", (PyCFunction)HBBuffer_is_empty, METH_NOARGS, ""},
    {nullptr, nullptr, 0, nullptr}};

static PySequenceMethods HBBuffer_as_seq = {HBBuffer_len};

static PyTypeObject HBBufferType = []{
  PyTypeObject t = {PyVarObject_HEAD_INIT(nullptr, 0)};
  t.tp_name = "_parsec_torch_native.HBBuffer";
  t.tp_basicsize = sizeof(HBBufferObject);
  t.tp_flags = Py_TPFLAGS_DEFAULT;
  t.tp_doc = "Bounded priority buffer; overflow spills to parent_push.";
  t.tp_new = HBBuffer_new;
  t.tp_init = HBBuffer_init;
  t.tp_dealloc = (destructor)HBBuffer_dealloc;
  t.tp_methods = HBBuffer_methods;
  t.tp_as_sequence = &HBBuffer_as_seq;
  return t;
}();

/* ================================================================== */
/* MaxHeap (ref: parsec/maxheap.c — heap-split stealing)               */
/* ================================================================== */
struct MaxHeapObject {
  PyObject_HEAD
  SpinLock* lock;
  std::vector<HBItem>* heap;
  uint64_t seq;
};

static PyObject* MaxHeap_new(PyTypeObject* type, PyObject*, PyObject*) {
  MaxHeapObject* self = (MaxHeapObject*)type->tp_alloc(type, 0);
  if (self) {
    self->lock = new SpinLock();
    self->heap = new std::vector<HBItem>();
    self->seq = 0;
  }
  return (PyObject*)self;
}

static void MaxHeap_dealloc(MaxHeapObject* self) {
  for (auto& e : *self->heap) Py_DECREF(e.item);
  delete self->heap;
  delete self->lock;
  Py_TYPE(self)->tp_free((PyObject*)self);
}

static PyObject* MaxHeap_insert(MaxHeapObject* self, PyObject* args,
                                PyObject* kwds) {
  static const char* kwlist[] = {"item", "priority", nullptr};
  PyObject* item;
  long long prio = 0;
  if (!PyArg_ParseTupleAndKeywords(args, kwds, "O|L", (char**)kwlist,
                                   &item, &prio))
    return nullptr;
  Py_INCREF(item);
  { SpinGuard g(*self->lock);
    self->heap->push_back({(int64_t)prio, self->seq++, item});
    std::push_heap(self->heap->begin(), self->heap->end(), hb_less); }
  Py_RETURN_NONE;
}

static PyObject* MaxHeap_pop_max(MaxHeapObject* self, PyObject*) {
  PyObject* item = nullptr;
  { SpinGuard g(*self->lock);
    if (!self->heap->empty()) {
      std::pop_heap(self->heap->begin(), self->heap->end(), hb_less);
      item = self->heap->back().item;
      self->heap->pop_back();
    } }
  if (!item) Py_RETURN_NONE;
  return item;
}

static PyObject* MaxHeap_split(MaxHeapObject* self, PyObject*) {
  PyObject* outo = PyObject_CallObject((PyObject*)Py_TYPE(self), nullptr);
  if (!outo) return nullptr;
  MaxHeapObject* out = (MaxHeapObject*)outo;
  std::vector<HBItem> stolen;
  { SpinGuard g(*self->lock);
    size_t half = self->heap->size() / 2;
    if (half > 0) {
      stolen.assign(self->heap->end() - half, self->heap->end());
      self->heap->resize(self->heap->size() - half);
      std::make_heap(self->heap->begin(), self->heap->end(), hb_less);
    } }
  if (!stolen.empty()) {
    /* references move (no incref): items leave self, enter out */
    *out->heap = std::move(stolen);
    std::make_heap(out->heap->begin(), out->heap->end(), hb_less);
    out->seq = self->seq;
  }
  return outo;
}

static Py_ssize_t MaxHeap_len(PyObject* o) {
  MaxHeapObject* self = (MaxHeapObject*)o;
  SpinGuard g(*self->lock);
  return (Py_ssize_t)self->heap->size();
}

static PyMethodDef MaxHeap_methods[] = {
    {"insert", (PyCFunction)MaxHeap_insert, METH_VARARGS | METH_KEYWORDS, ""},
    {"pop_max", (PyCFunction)MaxHeap_pop_max, METH_NOARGS, ""},
    {"split", (PyCFunction)MaxHeap_split, METH_NOARGS, ""},
    {nullptr, nullptr, 0, nullptr}};

static PySequenceMethods MaxHeap_as_seq = {MaxHeap_len};

static PyTypeObject MaxHeapType = []{
  PyTypeObject t = {PyVarObject_HEAD_INIT(nullptr, 0)};
  t.tp_name = "_parsec_torch_native.MaxHeap";
  t.tp_basicsize = sizeof(MaxHeapObject);
  t.tp_flags = Py_TPFLAGS_DEFAULT;
  t.tp_doc = "Priority max-heap with heap-split stealing.";
  t.tp_new = MaxHeap_new;
  t.tp_dealloc = (destructor)MaxHeap_dealloc;
  t.tp_methods = MaxHeap_methods;
  t.tp_as_sequence = &MaxHeap_as_seq;
  return t;
}();

/* ================================================================== */
/* NativeDAG — static dependence engine for lowered PTG taskpools      */
/*                                                                     */
/* The reference's static ("index-array") dependency-tracking mode     */
/* keeps dense per-class dependence counters and releases deps with    */
/* O(1) decrements in generated C (ref: ptg-compiler/main.c:37,        */
/* parsec_internal.h:173-196, jdf2c.c release_deps).  Here the lowered */
/* DAG (dsl/ptg/lower.py) hands us flat CSR successor arrays; complete */
/* walks a task's out-edges in C: route the produced DataCopy binding  */
/* to the consumer's flow slot, atomically decrement its indegree, and */
/* report freshly-ready ids.  Python touches a task exactly twice      */
/* (make_task + body), never per-edge.                                 */
/* ================================================================== */

template <typename T>
static bool dag_copy_buffer(PyObject* obj, std::vector<T>& out,
                            const char* name) {
  Py_buffer view;
  if (PyObject_GetBuffer(obj, &view, PyBUF_CONTIG_RO) != 0) return false;
  if (view.itemsize != (Py_ssize_t)sizeof(T)) {
    PyBuffer_Release(&view);
    PyErr_Format(PyExc_TypeError, "%s: expected itemsize %zu, got %zd", name,
                 sizeof(T), view.itemsize);
    return false;
  }
  size_t n = (size_t)view.len / sizeof(T);
  out.assign((const T*)view.buf, (const T*)view.buf + n);
  PyBuffer_Release(&view);
  return true;
}

constexpr int kDagLockStripes = 64;

struct DagObject {
  PyObject_HEAD
  int32_t n_tasks;
  int32_t max_flows;
  std::vector<int32_t>* indptr;
  std::vector<int32_t>* succ;
  std::vector<int8_t>* succ_flow;
  std::vector<int8_t>* out_flow;
  std::atomic<int32_t>* indeg;  /* length n_tasks */
  PyObject** bindings;          /* n_tasks * max_flows owned refs (or null) */
  SpinLock* locks;              /* striped by successor id */
  std::atomic<int64_t> completed;
};

static PyObject* Dag_new(PyTypeObject* type, PyObject* args, PyObject*) {
  PyObject *o_indptr, *o_succ, *o_sflow, *o_oflow, *o_indeg;
  int max_flows;
  if (!PyArg_ParseTuple(args, "OOOOOi", &o_indptr, &o_succ, &o_sflow,
                        &o_oflow, &o_indeg, &max_flows))
    return nullptr;
  if (max_flows < 0) {
    PyErr_SetString(PyExc_ValueError, "max_flows must be >= 0");
    return nullptr;
  }
  DagObject* self = (DagObject*)type->tp_alloc(type, 0);
  if (!self) return nullptr;
  self->indptr = new (std::nothrow) std::vector<int32_t>();
  self->succ = new (std::nothrow) std::vector<int32_t>();
  self->succ_flow = new (std::nothrow) std::vector<int8_t>();
  self->out_flow = new (std::nothrow) std::vector<int8_t>();
  self->indeg = nullptr;
  self->bindings = nullptr;
  self->locks = new (std::nothrow) SpinLock[kDagLockStripes];
  self->completed.store(0);
  std::vector<int32_t> indeg_in;
  if (!self->indptr || !self->succ || !self->succ_flow || !self->out_flow ||
      !self->locks ||
      !dag_copy_buffer(o_indptr, *self->indptr, "indptr") ||
      !dag_copy_buffer(o_succ, *self->succ, "succ") ||
      !dag_copy_buffer(o_sflow, *self->succ_flow, "succ_flow") ||
      !dag_copy_buffer(o_oflow, *self->out_flow, "out_flow") ||
      !dag_copy_buffer(o_indeg, indeg_in, "indegree")) {
    Py_DECREF(self);
    return nullptr;
  }
  size_t n = indeg_in.size();
  if (self->indptr->size() != n + 1 ||
      self->succ->size() != self->succ_flow->size() ||
      self->succ->size() != self->out_flow->size() ||
      (size_t)self->indptr->back() != self->succ->size()) {
    PyErr_SetString(PyExc_ValueError, "inconsistent DAG array sizes");
    Py_DECREF(self);
    return nullptr;
  }
  for (int32_t s : *self->succ)
    if (s < 0 || (size_t)s >= n) {
      PyErr_SetString(PyExc_ValueError, "successor id out of range");
      Py_DECREF(self);
      return nullptr;
    }
  for (size_t i = 0; i + 1 < self->indptr->size(); i++)
    if ((*self->indptr)[i] < 0 || (*self->indptr)[i] > (*self->indptr)[i + 1]) {
      PyErr_SetString(PyExc_ValueError, "indptr must be non-negative and "
                                        "monotonically non-decreasing");
      Py_DECREF(self);
      return nullptr;
    }
  self->n_tasks = (int32_t)n;
  self->max_flows = max_flows;
  self->indeg = new (std::nothrow) std::atomic<int32_t>[n];
  self->bindings =
      (PyObject**)PyMem_Calloc(n * (size_t)max_flows + 1, sizeof(PyObject*));
  if (!self->indeg || !self->bindings) {
    PyErr_NoMemory();
    Py_DECREF(self);
    return nullptr;
  }
  for (size_t i = 0; i < n; i++) self->indeg[i].store(indeg_in[i]);
  return (PyObject*)self;
}

static void Dag_dealloc(DagObject* self) {
  if (self->bindings) {
    for (size_t i = 0; i < (size_t)self->n_tasks * self->max_flows; i++)
      Py_XDECREF(self->bindings[i]);
    PyMem_Free(self->bindings);
  }
  delete self->indptr;
  delete self->succ;
  delete self->succ_flow;
  delete self->out_flow;
  delete[] self->indeg;
  delete[] self->locks;
  Py_TYPE(self)->tp_free((PyObject*)self);
}

static PyObject* Dag_start(DagObject* self, PyObject*) {
  PyObject* out = PyList_New(0);
  if (!out) return nullptr;
  for (int32_t t = 0; t < self->n_tasks; t++)
    if (self->indeg[t].load(std::memory_order_relaxed) == 0) {
      PyObject* v = PyLong_FromLong(t);
      if (!v || PyList_Append(out, v) < 0) {
        Py_XDECREF(v);
        Py_DECREF(out);
        return nullptr;
      }
      Py_DECREF(v);
    }
  return out;
}

/* core edge walk shared by complete / complete_batch; copies==nullptr
 * skips binding routing.  Appends newly-ready ids to `ready`. */
static int dag_release_edges(DagObject* self, int32_t tid, PyObject* copies,
                             std::vector<int32_t>& ready) {
  if (tid < 0 || tid >= self->n_tasks) {
    PyErr_Format(PyExc_IndexError, "task id %d out of range", (int)tid);
    return -1;
  }
  int32_t lo = (*self->indptr)[tid], hi = (*self->indptr)[tid + 1];
  for (int32_t e = lo; e < hi; e++) {
    int32_t sid = (*self->succ)[e];
    if (copies) {
      int of = (*self->out_flow)[e];
      if (of < 0 || of >= (int)PyTuple_GET_SIZE(copies)) {
        PyErr_Format(PyExc_IndexError, "out flow %d outside copies tuple",
                     of);
        return -1;
      }
      PyObject* cp = PyTuple_GET_ITEM(copies, of);
      if (cp != Py_None) {
        int sf = (*self->succ_flow)[e];
        if (sf < 0 || sf >= self->max_flows) {
          PyErr_Format(PyExc_IndexError, "succ flow %d out of range", sf);
          return -1;
        }
        PyObject** slot = &self->bindings[(size_t)sid * self->max_flows + sf];
        Py_INCREF(cp);
        PyObject* old;
        {
          SpinGuard g(self->locks[sid % kDagLockStripes]);
          old = *slot;
          *slot = cp;
        }
        Py_XDECREF(old);
      }
    }
    int32_t left =
        self->indeg[sid].fetch_sub(1, std::memory_order_acq_rel) - 1;
    if (left == 0) ready.push_back(sid);
    if (left < 0) {
      PyErr_Format(PyExc_RuntimeError,
                   "task %d released more times than its indegree",
                   (int)sid);
      return -1;
    }
  }
  self->completed.fetch_add(1, std::memory_order_relaxed);
  return 0;
}

static PyObject* dag_ready_list(const std::vector<int32_t>& ready) {
  PyObject* out = PyList_New((Py_ssize_t)ready.size());
  if (!out) return nullptr;
  for (size_t i = 0; i < ready.size(); i++) {
    PyObject* v = PyLong_FromLong(ready[i]);
    if (!v) {
      Py_DECREF(out);
      return nullptr;
    }
    PyList_SET_ITEM(out, (Py_ssize_t)i, v);
  }
  return out;
}

static PyObject* Dag_complete(DagObject* self, PyObject* args) {
  int tid;
  PyObject* copies = Py_None;
  if (!PyArg_ParseTuple(args, "i|O", &tid, &copies)) return nullptr;
  if (copies != Py_None && !PyTuple_Check(copies)) {
    PyErr_SetString(PyExc_TypeError, "copies must be a tuple or None");
    return nullptr;
  }
  std::vector<int32_t> ready;
  if (dag_release_edges(self, tid, copies == Py_None ? nullptr : copies,
                        ready) < 0)
    return nullptr;
  return dag_ready_list(ready);
}

static PyObject* Dag_complete_batch(DagObject* self, PyObject* args) {
  PyObject* ids;
  if (!PyArg_ParseTuple(args, "O", &ids)) return nullptr;
  std::vector<int32_t> tids;
  Py_buffer view;
  if (PyObject_GetBuffer(ids, &view, PyBUF_CONTIG_RO) == 0) {
    if (view.itemsize != 4) {
      PyBuffer_Release(&view);
      PyErr_SetString(PyExc_TypeError, "ids buffer must be int32");
      return nullptr;
    }
    tids.assign((const int32_t*)view.buf,
                (const int32_t*)view.buf + view.len / 4);
    PyBuffer_Release(&view);
  } else {
    PyErr_Clear();
    PyObject* seq = PySequence_Fast(ids, "ids must be a buffer or sequence");
    if (!seq) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    tids.reserve((size_t)n);
    for (Py_ssize_t i = 0; i < n; i++) {
      long v = PyLong_AsLong(PySequence_Fast_GET_ITEM(seq, i));
      if (v == -1 && PyErr_Occurred()) {
        Py_DECREF(seq);
        return nullptr;
      }
      tids.push_back((int32_t)v);
    }
    Py_DECREF(seq);
  }
  std::vector<int32_t> ready;
  for (int32_t t : tids)
    if (dag_release_edges(self, t, nullptr, ready) < 0) return nullptr;
  return dag_ready_list(ready);
}

/* The reference's select->release hot loop (scheduling.c:586-625) in
 * one C call: a priority max-heap over the counter arrays drives the
 * whole DAG; Python is re-entered exactly once per task (the chore
 * invocation).  Consumes the engine's counters (single-shot, like
 * start/complete).  Heap keys order by priority desc then task id asc
 * (deterministic tie-break). */
static inline int64_t dag_heap_key(int32_t prio, int32_t tid) {
  return ((int64_t)prio << 32) | (uint32_t)(INT32_MAX - tid);
}

static PyObject* Dag_run_loop(DagObject* self, PyObject* args) {
  PyObject* tramp;
  PyObject* o_prio;
  if (!PyArg_ParseTuple(args, "OO", &tramp, &o_prio)) return nullptr;
  if (!PyCallable_Check(tramp)) {
    PyErr_SetString(PyExc_TypeError, "trampoline must be callable");
    return nullptr;
  }
  std::vector<int32_t> prio;
  if (!dag_copy_buffer(o_prio, prio, "priority")) return nullptr;
  if ((int32_t)prio.size() != self->n_tasks) {
    PyErr_Format(PyExc_ValueError, "priority array has %zu entries for "
                 "%d tasks", prio.size(), (int)self->n_tasks);
    return nullptr;
  }
  std::vector<int64_t> heap;
  heap.reserve((size_t)self->n_tasks);
  for (int32_t t = 0; t < self->n_tasks; t++)
    if (self->indeg[t].load(std::memory_order_relaxed) == 0)
      heap.push_back(dag_heap_key(prio[t], t));
  std::make_heap(heap.begin(), heap.end());
  long executed = 0;
  std::vector<int32_t> ready;
  while (!heap.empty()) {
    std::pop_heap(heap.begin(), heap.end());
    int64_t k = heap.back();
    heap.pop_back();
    int32_t tid = INT32_MAX - (int32_t)(k & 0xffffffff);
    PyObject* r = PyObject_CallFunction(tramp, "i", (int)tid);
    if (!r) return nullptr;   /* body raised: propagate, DAG aborts */
    Py_DECREF(r);
    ready.clear();
    if (dag_release_edges(self, tid, nullptr, ready) < 0) return nullptr;
    for (int32_t s : ready) {
      heap.push_back(dag_heap_key(prio[s], s));
      std::push_heap(heap.begin(), heap.end());
    }
    executed++;
  }
  return PyLong_FromLong(executed);
}

static PyObject* Dag_take_bindings(DagObject* self, PyObject* args) {
  int tid;
  if (!PyArg_ParseTuple(args, "i", &tid)) return nullptr;
  if (tid < 0 || tid >= self->n_tasks) {
    PyErr_Format(PyExc_IndexError, "task id %d out of range", tid);
    return nullptr;
  }
  PyObject* out = PyTuple_New(self->max_flows);
  if (!out) return nullptr;
  PyObject** base = &self->bindings[(size_t)tid * self->max_flows];
  for (int f = 0; f < self->max_flows; f++) {
    PyObject* v;
    {
      SpinGuard g(self->locks[tid % kDagLockStripes]);
      v = base[f];
      base[f] = nullptr;
    }
    if (!v) {
      Py_INCREF(Py_None);
      v = Py_None;
    }
    PyTuple_SET_ITEM(out, f, v); /* ref transferred */
  }
  return out;
}

static PyObject* Dag_indegree_of(DagObject* self, PyObject* args) {
  int tid;
  if (!PyArg_ParseTuple(args, "i", &tid)) return nullptr;
  if (tid < 0 || tid >= self->n_tasks) {
    PyErr_Format(PyExc_IndexError, "task id %d out of range", tid);
    return nullptr;
  }
  return PyLong_FromLong(self->indeg[tid].load(std::memory_order_relaxed));
}

static PyObject* Dag_completed(DagObject* self, PyObject*) {
  return PyLong_FromLongLong(self->completed.load(std::memory_order_relaxed));
}

static Py_ssize_t Dag_len(PyObject* o) {
  return (Py_ssize_t)((DagObject*)o)->n_tasks;
}

static PyMethodDef Dag_methods[] = {
    {"start", (PyCFunction)Dag_start, METH_NOARGS,
     "ids with indegree 0 (the startup set)"},
    {"complete", (PyCFunction)Dag_complete, METH_VARARGS,
     "complete(tid, copies_tuple=None) -> newly ready ids; routes each "
     "non-None copies[out_flow] into the successor's flow slot"},
    {"complete_batch", (PyCFunction)Dag_complete_batch, METH_VARARGS,
     "complete_batch(int32 ids) -> newly ready ids (no binding routing)"},
    {"run_loop", (PyCFunction)Dag_run_loop, METH_VARARGS,
     "run_loop(trampoline, int32 priorities) -> executed count; drives "
     "the whole DAG from a C priority heap, calling trampoline(tid) "
     "once per task (single-shot: consumes the counters)"},
    {"take_bindings", (PyCFunction)Dag_take_bindings, METH_VARARGS,
     "take_bindings(tid) -> tuple of max_flows entries (refs transferred)"},
    {"indegree_of", (PyCFunction)Dag_indegree_of, METH_VARARGS, ""},
    {"completed", (PyCFunction)Dag_completed, METH_NOARGS,
     "number of complete()/complete_batch() task releases so far"},
    {nullptr, nullptr, 0, nullptr}};

static PySequenceMethods Dag_as_seq = {Dag_len};

static PyTypeObject DagType = []{
  PyTypeObject t = {PyVarObject_HEAD_INIT(nullptr, 0)};
  t.tp_name = "_parsec_torch_native.NativeDAG";
  t.tp_basicsize = sizeof(DagObject);
  t.tp_flags = Py_TPFLAGS_DEFAULT;
  t.tp_doc = "Static dependence engine over a lowered PTG DAG.";
  t.tp_new = Dag_new;
  t.tp_dealloc = (destructor)Dag_dealloc;
  t.tp_methods = Dag_methods;
  t.tp_as_sequence = &Dag_as_seq;
  return t;
}();

/* ================================================================== */
/* RWLock (ref: parsec/class/parsec_rwlock.c — compact atomic         */
/* readers-writer lock). Write-preferring: a writer first serializes  */
/* against other writers, then raises the writer flag so new readers  */
/* park, then waits for active readers to drain. Spins release the    */
/* GIL so Python threads genuinely contend.                           */
/* ================================================================== */
struct RWLockObject {
  PyObject_HEAD
  SpinLock wr;                       // writer-vs-writer serialization
  std::atomic<uint32_t> writer;      // a writer holds or awaits the lock
  std::atomic<int32_t> readers;      // active readers
};

static PyObject* RWLock_new(PyTypeObject* type, PyObject*, PyObject*) {
  RWLockObject* self = (RWLockObject*)type->tp_alloc(type, 0);
  if (!self) return nullptr;
  new (&self->wr) SpinLock();
  new (&self->writer) std::atomic<uint32_t>(0);
  new (&self->readers) std::atomic<int32_t>(0);
  return (PyObject*)self;
}

static void RWLock_dealloc(RWLockObject* self) {
  Py_TYPE(self)->tp_free((PyObject*)self);
}

static inline void rw_pause() {
#if defined(__x86_64__)
  __builtin_ia32_pause();
#endif
}

static PyObject* RWLock_read_lock(RWLockObject* self, PyObject*) {
  Py_BEGIN_ALLOW_THREADS
  for (;;) {
    while (self->writer.load(std::memory_order_acquire)) rw_pause();
    self->readers.fetch_add(1, std::memory_order_acquire);
    if (!self->writer.load(std::memory_order_acquire)) break;
    // a writer raised its flag between our check and increment: back
    // out so it can drain, then retry behind it
    self->readers.fetch_sub(1, std::memory_order_release);
  }
  Py_END_ALLOW_THREADS
  Py_RETURN_NONE;
}

static PyObject* RWLock_read_unlock(RWLockObject* self, PyObject*) {
  self->readers.fetch_sub(1, std::memory_order_release);
  Py_RETURN_NONE;
}

static PyObject* RWLock_write_lock(RWLockObject* self, PyObject*) {
  Py_BEGIN_ALLOW_THREADS
  self->wr.lock();
  self->writer.store(1, std::memory_order_release);
  while (self->readers.load(std::memory_order_acquire) > 0) rw_pause();
  Py_END_ALLOW_THREADS
  Py_RETURN_NONE;
}

static PyObject* RWLock_write_unlock(RWLockObject* self, PyObject*) {
  self->writer.store(0, std::memory_order_release);
  self->wr.unlock();
  Py_RETURN_NONE;
}

static PyObject* RWLock_nreaders(RWLockObject* self, PyObject*) {
  return PyLong_FromLong(self->readers.load(std::memory_order_relaxed));
}

static PyMethodDef RWLock_methods[] = {
    {"read_lock", (PyCFunction)RWLock_read_lock, METH_NOARGS,
     "acquire in shared mode (spins while a writer holds or awaits)"},
    {"read_unlock", (PyCFunction)RWLock_read_unlock, METH_NOARGS, ""},
    {"write_lock", (PyCFunction)RWLock_write_lock, METH_NOARGS,
     "acquire exclusively (serializes writers, drains readers)"},
    {"write_unlock", (PyCFunction)RWLock_write_unlock, METH_NOARGS, ""},
    {"nreaders", (PyCFunction)RWLock_nreaders, METH_NOARGS,
     "active reader count (diagnostic)"},
    {nullptr, nullptr, 0, nullptr}};

static PyTypeObject RWLockType = []{
  PyTypeObject t = {PyVarObject_HEAD_INIT(nullptr, 0)};
  t.tp_name = "_parsec_torch_native.RWLock";
  t.tp_basicsize = sizeof(RWLockObject);
  t.tp_flags = Py_TPFLAGS_DEFAULT;
  t.tp_doc = "Write-preferring atomic readers-writer lock.";
  t.tp_new = RWLock_new;
  t.tp_dealloc = (destructor)RWLock_dealloc;
  t.tp_methods = RWLock_methods;
  return t;
}();

/* ================================================================== */
/* ValueArray (ref: parsec/class/value_array.h — growable array of    */
/* fixed-size byte elements; items are raw bytes, zero-filled on      */
/* growth).                                                           */
/* ================================================================== */
struct ValueArrayObject {
  PyObject_HEAD
  Py_ssize_t item_size;
  Py_ssize_t nitems;
  std::vector<unsigned char>* buf;
  SpinLock lock;
};

static PyObject* VA_new(PyTypeObject* type, PyObject* args, PyObject*) {
  Py_ssize_t item_size;
  if (!PyArg_ParseTuple(args, "n", &item_size)) return nullptr;
  if (item_size <= 0) {
    PyErr_SetString(PyExc_ValueError, "item_size must be positive");
    return nullptr;
  }
  ValueArrayObject* self = (ValueArrayObject*)type->tp_alloc(type, 0);
  if (!self) return nullptr;
  self->item_size = item_size;
  self->nitems = 0;
  self->buf = new std::vector<unsigned char>();
  new (&self->lock) SpinLock();
  return (PyObject*)self;
}

static void VA_dealloc(ValueArrayObject* self) {
  delete self->buf;
  Py_TYPE(self)->tp_free((PyObject*)self);
}

static PyObject* VA_set_size(ValueArrayObject* self, PyObject* args) {
  Py_ssize_t n;
  if (!PyArg_ParseTuple(args, "n", &n)) return nullptr;
  if (n < 0) {
    PyErr_SetString(PyExc_ValueError, "negative size");
    return nullptr;
  }
  {
    SpinGuard g(self->lock);
    self->buf->resize((size_t)(n * self->item_size), 0);
    self->nitems = n;
  }
  Py_RETURN_NONE;
}

static PyObject* VA_get(ValueArrayObject* self, PyObject* args) {
  Py_ssize_t i;
  if (!PyArg_ParseTuple(args, "n", &i)) return nullptr;
  SpinGuard g(self->lock);
  if (i < 0 || i >= self->nitems) {
    PyErr_SetString(PyExc_IndexError, "ValueArray index out of range");
    return nullptr;
  }
  return PyBytes_FromStringAndSize(
      (const char*)self->buf->data() + i * self->item_size,
      self->item_size);
}

static PyObject* VA_set(ValueArrayObject* self, PyObject* args) {
  Py_ssize_t i;
  Py_buffer view;
  if (!PyArg_ParseTuple(args, "ny*", &i, &view)) return nullptr;
  bool bad_len = view.len != self->item_size;
  bool bad_idx = false;
  if (!bad_len) {
    SpinGuard g(self->lock);
    if (i < 0 || i >= self->nitems) {
      bad_idx = true;
    } else {
      std::memcpy(self->buf->data() + i * self->item_size, view.buf,
                  (size_t)self->item_size);
    }
  }
  PyBuffer_Release(&view);
  if (bad_len) {
    PyErr_Format(PyExc_ValueError, "expected %zd bytes per item",
                 self->item_size);
    return nullptr;
  }
  if (bad_idx) {
    PyErr_SetString(PyExc_IndexError, "ValueArray index out of range");
    return nullptr;
  }
  Py_RETURN_NONE;
}

static PyObject* VA_push_back(ValueArrayObject* self, PyObject* args) {
  Py_buffer view;
  if (!PyArg_ParseTuple(args, "y*", &view)) return nullptr;
  if (view.len != self->item_size) {
    PyBuffer_Release(&view);
    PyErr_Format(PyExc_ValueError, "expected %zd bytes per item",
                 self->item_size);
    return nullptr;
  }
  Py_ssize_t idx;
  {
    SpinGuard g(self->lock);
    idx = self->nitems;
    self->buf->resize((size_t)((idx + 1) * self->item_size));
    std::memcpy(self->buf->data() + idx * self->item_size, view.buf,
                (size_t)self->item_size);
    self->nitems = idx + 1;
  }
  PyBuffer_Release(&view);
  return PyLong_FromSsize_t(idx);
}

static PyObject* VA_item_size(ValueArrayObject* self, PyObject*) {
  return PyLong_FromSsize_t(self->item_size);
}

static Py_ssize_t VA_len(PyObject* o) {
  ValueArrayObject* self = (ValueArrayObject*)o;
  SpinGuard g(self->lock);
  return self->nitems;
}

static PyMethodDef VA_methods[] = {
    {"set_size", (PyCFunction)VA_set_size, METH_VARARGS,
     "resize to n items (growth zero-fills)"},
    {"get", (PyCFunction)VA_get, METH_VARARGS, "get(i) -> bytes"},
    {"set", (PyCFunction)VA_set, METH_VARARGS, "set(i, bytes)"},
    {"push_back", (PyCFunction)VA_push_back, METH_VARARGS,
     "append one item, returns its index"},
    {"item_size", (PyCFunction)VA_item_size, METH_NOARGS, ""},
    {nullptr, nullptr, 0, nullptr}};

static PySequenceMethods VA_as_seq = {VA_len};

static PyTypeObject VAType = []{
  PyTypeObject t = {PyVarObject_HEAD_INIT(nullptr, 0)};
  t.tp_name = "_parsec_torch_native.ValueArray";
  t.tp_basicsize = sizeof(ValueArrayObject);
  t.tp_flags = Py_TPFLAGS_DEFAULT;
  t.tp_doc = "Growable array of fixed-size byte elements.";
  t.tp_new = VA_new;
  t.tp_dealloc = (destructor)VA_dealloc;
  t.tp_methods = VA_methods;
  t.tp_as_sequence = &VA_as_seq;
  return t;
}();

/* ================================================================== */
/* module                                                              */
/* ================================================================== */
static PyModuleDef native_module = {
    PyModuleDef_HEAD_INIT, "_parsec_torch_native",
    "Native runtime core for parsec_tpu_torch.", -1, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit__parsec_torch_native(void) {
  PyObject* m = PyModule_Create(&native_module);
  if (!m) return nullptr;
  struct {
    const char* name;
    PyTypeObject* type;
  } types[] = {
      {"Lifo", &LifoType},       {"Fifo", &FifoType},
      {"Dequeue", &DequeueType}, {"OrderedList", &OrderedType},
      {"HashTable64", &HT64Type}, {"ZoneMalloc", &ZoneType},
      {"HBBuffer", &HBBufferType}, {"MaxHeap", &MaxHeapType},
      {"NativeDAG", &DagType},     {"RWLock", &RWLockType},
      {"ValueArray", &VAType},
  };
  for (auto& t : types) {
    if (PyType_Ready(t.type) < 0) return nullptr;
    Py_INCREF(t.type);
    if (PyModule_AddObject(m, t.name, (PyObject*)t.type) < 0) return nullptr;
  }
  PyModule_AddStringConstant(m, "__version__", "0.1.0");
  return m;
}
